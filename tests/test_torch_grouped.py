"""The port's grouped backend against the JAX package's.

``compile_grouped`` must give the reference's segments, source tables,
weights and node order; the grouped route sweep, through each of the two
contraction kernels (``impl="batched_minplus"`` and
``"batched_minplus_t"``, their plain versions on the CPU), must give the
reference's route product under its Pallas kernels in interpret mode
(``"pallas"`` and ``"pallas_t"``), exactly; the port's grouped and ELL
sweeps must agree by node name; and the route tables must equal the host
Dijkstra oracle's. The grid and random-mesh networks degrade to
singleton groups.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

from openr_tpu.models import topologies as jax_topologies
from openr_tpu.ops import spf_grouped as jax_grouped
from openr_tpu_torch import carry
from openr_tpu_torch.kernels import LAUNCHES
from openr_tpu_torch.ops import route_sweep as port_sweep
from openr_tpu_torch.ops import spf_grouped as port_grouped
from openr_tpu_torch.ops.minplus import INF
from tests.test_torch_solver import Twin

CPU = torch.device("cpu")
FIELDS = ("digests", "nh_totals", "sample_metrics", "sample_masks")
# port impl -> the reference's Pallas kernel of the same layout
JAX_IMPL = {"batched_minplus": "pallas", "batched_minplus_t": "pallas_t"}


def _network(kind: str) -> Twin:
    if kind == "fat_tree":
        topo = jax_topologies.fat_tree(
            pods=3, ssw_per_plane=2, fsw_per_pod=2, rsw_per_pod=4
        )
        topo.adj_dbs["fsw-1-0"] = replace(
            topo.adj_dbs["fsw-1-0"], is_overloaded=True
        )
        return Twin(topo)
    if kind == "small_fat_tree":
        return Twin(jax_topologies.fat_tree(
            pods=2, ssw_per_plane=2, fsw_per_pod=2, rsw_per_pod=3
        ))
    if kind == "grid":
        topo = jax_topologies.grid(4)
        topo.adj_dbs["node-5"] = replace(topo.adj_dbs["node-5"], is_overloaded=True)
        return Twin(topo)
    if kind == "mesh":
        return Twin(jax_topologies.random_mesh(20, degree=4, seed=3, max_metric=9))
    if kind == "ring":
        return Twin(jax_topologies.ring(12, metric=3))
    if kind == "asymmetric":
        twin = Twin(jax_topologies.ring(6, metric=1))
        db = twin.adj("node-0")
        twin.set_adj(replace(db, adjacencies=tuple(
            replace(a, metric=7) for a in db.adjacencies
        )))
        return twin
    raise ValueError(kind)


KINDS = ["fat_tree", "small_fat_tree", "grid", "mesh", "ring", "asymmetric"]


@pytest.fixture
def jax_impl():
    before = jax_grouped._GROUPED_IMPL
    yield jax_grouped.set_grouped_impl
    jax_grouped.set_grouped_impl(before)


def _names(twin):
    return sorted(twin.ls.get_adjacency_databases())


def _same_product(got, want):
    for field in FIELDS:
        np.testing.assert_array_equal(
            getattr(got, field), getattr(want, field), err_msg=field
        )


def _same_graph(got, want):
    assert got.node_names == want.node_names
    assert got.node_index == want.node_index
    assert (got.n, got.n_pad, got.direction) == (want.n, want.n_pad, want.direction)
    np.testing.assert_array_equal(got.overloaded, want.overloaded)
    assert len(got.bands) == len(want.bands)
    for gb, wb in zip(got.bands, want.bands):
        assert (gb.start, gb.g1, gb.g2) == (wb.start, wb.g1, wb.g2)
        assert len(gb.segments) == len(wb.segments)
        for gs, ws in zip(gb.segments, wb.segments):
            assert gs.axis == ws.axis
            assert gs.src.dtype == gs.w.dtype == np.int32
            np.testing.assert_array_equal(gs.src, ws.src)
            np.testing.assert_array_equal(gs.w, ws.w)


@pytest.mark.parametrize("direction", ["in", "out"])
@pytest.mark.parametrize("kind", KINDS)
def test_compile_grouped_matches_field_by_field(kind, direction):
    twin = _network(kind)
    want = jax_grouped.compile_grouped(twin.jax_ls, direction=direction)
    got = port_grouped.compile_grouped(twin.ls, direction=direction)
    _same_graph(got, want)
    assert port_grouped.structure_report(got) == jax_grouped.structure_report(want)
    for nid in (0, got.n // 2, got.n - 1):
        for g, w in zip(got.out_slots(nid), want.out_slots(nid)):
            np.testing.assert_array_equal(g, w)


def test_structure_detection_fires_on_a_fabric_and_degrades_on_a_grid():
    fabric = port_grouped.structure_report(
        port_grouped.compile_out_grouped(_network("fat_tree").ls)
    )
    assert fabric["gather_shrink"] > 1.5
    assert any(b["g2"] > 1 for b in fabric["bands"])
    grid = port_grouped.structure_report(
        port_grouped.compile_out_grouped(_network("grid").ls)
    )
    assert grid["gather_shrink"] == 1.0
    assert all(b["g2"] == 1 for b in grid["bands"])


@pytest.mark.parametrize("impl", port_grouped.IMPLS)
@pytest.mark.parametrize("kind", KINDS)
def test_grouped_sweep_matches_pallas_reference(kind, impl, jax_impl):
    twin = _network(kind)
    names = _names(twin)
    samples = [names[0], names[len(names) // 2]]
    jax_impl(JAX_IMPL[impl])
    want = jax_grouped.GroupedRouteSweeper(
        jax_grouped.compile_out_grouped(twin.jax_ls), samples
    ).sweep(block=16)
    sweeper = port_grouped.GroupedRouteSweeper(
        port_grouped.compile_out_grouped(twin.ls), samples, impl=impl, device=CPU
    )
    got = sweeper.sweep(block=16)
    _same_product(got, want)
    np.testing.assert_array_equal(got.samp_v, want.samp_v)
    np.testing.assert_array_equal(got.samp_w, want.samp_w)
    assert len(sweeper.block_hops) == -(-got.graph.n_pad // 16)
    assert all(v == 0 for v in LAUNCHES.values())


@pytest.mark.parametrize("impl", port_grouped.IMPLS)
@pytest.mark.parametrize("kind", KINDS)
def test_grouped_and_ell_digests_agree_by_name(kind, impl):
    twin = _network(kind)
    samples = [_names(twin)[1]]
    ell = port_sweep.all_sources_route_sweep(twin.ls, samples, block=32, device=CPU)
    grouped = port_grouped.GroupedRouteSweeper(
        port_grouped.compile_out_grouped(twin.ls), samples, impl=impl, device=CPU
    ).sweep(block=32)
    assert port_sweep.digests_by_name(grouped) == port_sweep.digests_by_name(ell)
    assert grouped.routes_from(samples[0]) == ell.routes_from(samples[0])


@pytest.mark.parametrize("impl", port_grouped.IMPLS)
@pytest.mark.parametrize("kind", ["small_fat_tree", "grid", "asymmetric"])
def test_grouped_route_tables_match_oracle(kind, impl):
    twin = _network(kind)
    names = _names(twin)
    result = port_grouped.GroupedRouteSweeper(
        port_grouped.compile_out_grouped(twin.ls), names, impl=impl, device=CPU
    ).sweep(block=16)
    for src in names:
        got = result.routes_from(src)
        oracle = twin.ls.run_spf(src)
        for dst in names:
            if dst == src:
                continue
            want = oracle.get(dst)
            if want is None:
                assert dst not in got, (src, dst)
                continue
            assert got[dst] == (want.metric, set(want.next_hops)), (src, dst)


@pytest.mark.parametrize("impl", port_grouped.IMPLS)
@pytest.mark.parametrize("kind", ["fat_tree", "grid", "mesh"])
def test_forward_distances_match_reference(kind, impl, jax_impl):
    twin = _network(kind)
    graph = jax_grouped.compile_grouped(twin.jax_ls)
    ids = np.arange(graph.n, dtype=np.int32)
    jax_impl(JAX_IMPL[impl])
    want = np.asarray(jax_grouped.grouped_distances_from_sources(graph, ids))
    port_graph = port_grouped.compile_grouped(twin.ls)
    got = port_grouped.grouped_distances_from_sources(
        port_graph, ids, impl=impl, device=CPU
    )
    np.testing.assert_array_equal(got.numpy(), want)
    for src in port_graph.node_names[:4]:
        oracle = twin.ls.run_spf(src)
        row = got[port_graph.node_index[src]]
        for dst, res in oracle.items():
            assert int(row[port_graph.node_index[dst]]) == res.metric
        unreached = set(port_graph.node_names) - set(oracle)
        assert all(int(row[port_graph.node_index[d]]) == INF for d in unreached)


def test_sweeper_on_carried_reference_segments():
    twin = _network("fat_tree")
    graph = jax_grouped.compile_out_grouped(twin.jax_ls)
    port_graph = carry.grouped_from_numpy(
        graph.node_names,
        [
            (b.start, b.g1, b.g2, [(s.axis, s.src, s.w) for s in b.segments])
            for b in graph.bands
        ],
        graph.overloaded, graph.direction,
    )
    _same_graph(port_graph, graph)
    samples = [graph.node_names[0]]
    got = port_grouped.GroupedRouteSweeper(port_graph, samples, device=CPU).sweep(block=32)
    want = jax_grouped.GroupedRouteSweeper(graph, samples).sweep(block=32)
    _same_product(got, want)


def test_grouped_rejects_unknown_impl_and_in_graph():
    twin = _network("ring")
    with pytest.raises(ValueError, match="grouped impl"):
        port_grouped.GroupedRouteSweeper(
            port_grouped.compile_out_grouped(twin.ls), ["node-0"], impl="jnp",
            device=CPU,
        )
    with pytest.raises(ValueError, match="out-edge"):
        port_grouped.GroupedRouteSweeper(
            port_grouped.compile_grouped(twin.ls), ["node-0"], device=CPU
        )
