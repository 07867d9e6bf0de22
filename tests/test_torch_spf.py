"""The port's graph compilers and SPF views against the JAX package's.

Both packages compile the same network (the JAX package's generators,
handed to the port through ``openr_tpu_torch.carry``): the dense
snapshot and the sliced-ELL bands must match field by field, and the
batched SPF views solved by the port (on CPU tensors, through the plain
kernel versions) must equal the JAX package's, exactly. The view
comparisons feed both packages the JAX package's own compiled arrays,
carried into the port as numpy.
"""

from __future__ import annotations

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.graph import snapshot as jax_snapshot
from openr_tpu.models import topologies as jax_topologies
from openr_tpu.ops import spf as jax_spf
from openr_tpu.ops import spf_sparse as jax_sparse
from openr_tpu_torch import carry
from openr_tpu_torch.graph import snapshot as port_snapshot
from openr_tpu_torch.ops import spf as port_spf
from openr_tpu_torch.ops import spf_sparse as port_sparse
from tests.test_torch_solver import Twin

CPU = torch.device("cpu")


def _network(kind: str) -> Twin:
    """Test topologies with overloaded nodes and parallel links."""
    if kind == "fat_tree":
        topo = jax_topologies.fat_tree(2, ssw_per_plane=2, rsw_per_pod=4)
    elif kind == "grid":
        topo = jax_topologies.grid(5, metric=2)
    elif kind == "ring":
        topo = jax_topologies.ring(9, metric=3)
    elif kind == "mesh":
        topo = jax_topologies.random_mesh(40, degree=5, seed=11)
    elif kind == "lag":
        edges = [("a", "b", 1), ("a", "b", 3), ("b", "c", 2), ("a", "d", 5),
                 ("d", "c", 1), ("c", "e", 1), ("b", "e", 4), ("b", "e", 2),
                 ("e", "f", 7), ("f", "a", 9)]
        topo = jax_topologies.build_topology("lag", edges)
    else:
        raise ValueError(kind)
    names = sorted(topo.adj_dbs)
    for name in names[1::4]:
        topo.adj_dbs[name] = replace(topo.adj_dbs[name], is_overloaded=True)
    return Twin(topo)


KINDS = ["fat_tree", "grid", "ring", "mesh", "lag"]


def _same_snapshot(got, want):
    assert got.node_names == want.node_names
    assert got.node_index == want.node_index
    assert (got.n, got.n_pad, got.version) == (want.n, want.n_pad, want.version)
    np.testing.assert_array_equal(got.metric, want.metric)
    np.testing.assert_array_equal(got.overloaded, want.overloaded)
    assert [
        [(l.src, l.dst, l.src_id, l.dst_id, l.metric) for l in row]
        for row in got.links_from
    ] == [
        [(l.src, l.dst, l.src_id, l.dst_id, l.metric) for l in row]
        for row in want.links_from
    ]


@pytest.mark.parametrize("kind", KINDS)
def test_snapshot_compile_and_patch_match(kind):
    twin = _network(kind)
    jax_cache = jax_snapshot.SnapshotCache()
    port_cache = port_snapshot.SnapshotCache(CPU)
    want = jax_cache.get(twin.jax_ls)
    got = port_cache.get(twin.ls)
    _same_snapshot(got, want)
    dev = got.device_arrays(CPU)
    assert dev.metric.dtype == torch.int32 and dev.overloaded.dtype == torch.bool
    np.testing.assert_array_equal(dev.metric.numpy(), want.metric)

    # churn one node's metrics: both caches patch the same rows
    name = want.node_names[0]
    db = twin.adj(name)
    twin.set_adj(replace(db, adjacencies=tuple(
        replace(a, metric=a.metric + 4) for a in db.adjacencies)))
    want2 = jax_cache.get(twin.jax_ls)
    got2 = port_cache.get(twin.ls)
    _same_snapshot(got2, want2)
    np.testing.assert_array_equal(got2._changed_rows, want2._changed_rows)
    dev2 = got2.device_arrays(CPU)
    # the patched snapshot took the parent's tensor and patched it in place
    assert dev2.metric is dev.metric and got._dev is None
    np.testing.assert_array_equal(dev2.metric.numpy(), want2.metric)
    # the parent's host matrix is untouched by the in-place patch
    np.testing.assert_array_equal(got.metric, want.metric)


def _jax_view_inputs(twin: Twin):
    snap = jax_snapshot.compile_snapshot(twin.jax_ls)
    port_snap = carry.snapshot_from_numpy(
        snap.node_names, snap.metric, snap.overloaded, CPU
    )
    return snap, port_snap


@pytest.mark.parametrize("use_link_metric", [True, False], ids=["metric", "hops"])
@pytest.mark.parametrize("kind", KINDS)
def test_spf_view_batch_packed_matches(kind, use_link_metric):
    twin = _network(kind)
    snap, port_snap = _jax_view_inputs(twin)
    dev = port_snap._dev
    for sid in (0, snap.n // 2, snap.n - 1):
        real, srcs = jax_spf.source_batch(snap, sid)
        want = np.asarray(jax_spf.spf_view_batch_packed(
            jnp.asarray(snap.metric), jnp.asarray(snap.overloaded), srcs,
            use_link_metric,
        ))
        port_real, port_srcs = port_spf.source_batch(snap, sid, CPU)
        assert port_real == real
        np.testing.assert_array_equal(port_srcs.numpy(), np.asarray(srcs))
        got = port_spf.spf_view_batch_packed(
            dev.metric, dev.overloaded, port_srcs, use_link_metric
        )
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        d, fh = port_spf.spf_view_batch(
            dev.metric, dev.overloaded, port_srcs, use_link_metric
        )
        assert fh.dtype == torch.bool
        np.testing.assert_array_equal(
            torch.cat([d, fh.to(torch.int32)]).numpy(), want
        )


@pytest.mark.parametrize("kind", ["fat_tree", "mesh", "lag"])
def test_reconverge_step_after_row_patch_matches(kind):
    twin = _network(kind)
    snap, port_snap = _jax_view_inputs(twin)
    rng = np.random.default_rng(2)
    rows = np.sort(rng.choice(snap.n, size=3, replace=False)).astype(np.int32)
    vals = snap.metric[rows].copy()
    live = vals < jax_snapshot.INF
    vals[live] = rng.integers(1, 20, live.sum()).astype(np.int32)
    _, srcs = jax_spf.source_batch(snap, int(rows[0]))
    want_m, want_packed = jax_spf.reconverge_step(
        jnp.asarray(snap.metric), jnp.asarray(rows), jnp.asarray(vals),
        jnp.asarray(snap.overloaded), srcs,
    )
    metric = port_snap._dev.metric
    got_m, got_packed = port_spf.reconverge_step(
        metric, torch.from_numpy(rows), torch.from_numpy(vals),
        port_snap._dev.overloaded, torch.from_numpy(np.array(srcs)),
    )
    assert got_m is metric  # patched in place
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_packed.numpy(), np.asarray(want_packed))


@pytest.mark.parametrize("kind", ["grid", "mesh"])
def test_distances_and_all_pairs_match(kind):
    twin = _network(kind)
    snap, port_snap = _jax_view_inputs(twin)
    m, ov = port_snap._dev.metric, port_snap._dev.overloaded
    ids = np.asarray([0, 3, snap.n - 1, 3], dtype=np.int32)
    want = np.asarray(jax_spf.distances_from_sources(
        jnp.asarray(snap.metric), jnp.asarray(snap.overloaded), jnp.asarray(ids)))
    got = port_spf.distances_from_sources(m, ov, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jax_spf.all_pairs_distances(
        jnp.asarray(snap.metric), jnp.asarray(snap.overloaded)))
    np.testing.assert_array_equal(port_spf.all_pairs_distances(m, ov).numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
def test_compile_ell_matches_field_by_field(kind):
    twin = _network(kind)
    want = jax_sparse.compile_ell(twin.jax_ls)
    got = port_sparse.compile_ell(twin.ls)
    assert got.node_names == want.node_names
    assert got.node_index == want.node_index
    assert (got.n, got.n_pad) == (want.n, want.n_pad)
    assert [(b.start, b.rows, b.k) for b in got.bands] == [
        (b.start, b.rows, b.k) for b in want.bands
    ]
    for g, w in zip(got.src + got.w, want.src + want.w):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.overloaded, want.overloaded)
    assert got.slot_of == want.slot_of
    for name in (want.node_names[0], want.node_names[-1]):
        sid = want.node_index[name]
        np.testing.assert_array_equal(
            port_sparse.direct_metrics(got, sid, range(got.n)),
            jax_sparse.direct_metrics(want, sid, range(want.n)),
        )


@pytest.mark.parametrize("kind", KINDS)
def test_ell_view_batch_packed_matches(kind):
    twin = _network(kind)
    graph = jax_sparse.compile_ell(twin.jax_ls)
    port_graph = carry.ell_from_numpy(
        graph.node_names,
        [(b.start, b.rows, b.k) for b in graph.bands],
        graph.src, graph.w, graph.overloaded,
    )
    for name in (graph.node_names[0], graph.node_names[graph.n // 2]):
        srcs = jax_sparse.ell_source_batch(graph, twin.jax_ls, name)
        assert port_sparse.ell_source_batch(port_graph, twin.ls, name) == srcs
        want = np.asarray(jax_sparse.ell_view_batch_packed(graph, srcs))
        got = port_sparse.ell_view_batch_packed(port_graph, srcs, CPU)
        np.testing.assert_array_equal(got.numpy(), want)


def test_dense_and_sparse_views_agree_on_one_graph():
    # the two regimes are two layouts of one graph: same distances and
    # first hops per node name, whatever the node order
    twin = _network("mesh")
    snap = port_snapshot.compile_snapshot(twin.ls)
    dev = snap.device_arrays(CPU)
    graph = port_sparse.compile_ell(twin.ls)
    root = snap.node_names[5]
    real, srcs = port_spf.source_batch(snap, 5, CPU)
    dense = port_spf.spf_view_batch_packed(dev.metric, dev.overloaded, srcs).numpy()
    esrcs = port_sparse.ell_source_batch(graph, twin.ls, root)
    sparse = port_sparse.ell_view_batch_packed(graph, esrcs, CPU).numpy()
    b, eb = len(srcs), len(esrcs)
    for i, nid in enumerate(real):
        j = esrcs.index(graph.node_index[snap.node_names[nid]])
        perm = [graph.node_index[n] for n in snap.node_names]
        np.testing.assert_array_equal(dense[i, : snap.n], sparse[j, perm])
        np.testing.assert_array_equal(dense[b + i, : snap.n], sparse[eb + j, perm])
