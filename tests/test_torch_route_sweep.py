"""The port's all-sources route sweep (ELL backend) against the JAX package's.

The same networks (the JAX package's generators, handed to the port
through ``openr_tpu_torch.carry``) are swept by both packages with every
node a sample, so the whole route product is compared: digests,
per-destination next-hop totals, sample metrics and packed sample
next-hop masks must be equal, exactly. The reference runs its sweep with
the Pallas ``rev_band_relax`` kernel in interpret mode (and, in one test,
its jnp formulation); the port runs on CPU tensors, through the plain
version of its kernel. Both are also held against the host Dijkstra
oracle: every route table against the port's ``LinkState.run_spf``, and
every destination's digest against ``host_digest`` over it.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

from openr_tpu.models import topologies as jax_topologies
from openr_tpu.ops import route_sweep as jax_sweep
from openr_tpu.ops import spf_sparse as jax_sparse
from openr_tpu_torch import carry
from openr_tpu_torch.kernels import LAUNCHES
from openr_tpu_torch.ops import route_sweep as port_sweep
from openr_tpu_torch.ops import spf_sparse as port_sparse
from openr_tpu_torch.ops.minplus import INF
from tests.test_torch_solver import Twin

CPU = torch.device("cpu")
FIELDS = ("digests", "nh_totals", "sample_metrics", "sample_masks")


def _overload(topo, names):
    for name in names:
        topo.adj_dbs[name] = replace(topo.adj_dbs[name], is_overloaded=True)
    return topo


def _network(kind: str) -> Twin:
    """The topologies of the JAX package's own route-sweep tests."""
    if kind == "grid":
        return Twin(jax_topologies.grid(4))
    if kind == "ring":
        return Twin(jax_topologies.ring(10, metric=3))
    if kind.startswith("mesh"):
        seed = int(kind[-1])
        return Twin(jax_topologies.random_mesh(20, degree=4, seed=seed, max_metric=20))
    if kind == "fat_tree":
        return Twin(jax_topologies.fat_tree(
            pods=2, ssw_per_plane=2, fsw_per_pod=2, rsw_per_pod=3
        ))
    if kind == "overloaded_transit":
        return Twin(_overload(
            jax_topologies.random_mesh(18, degree=4, seed=5, max_metric=9),
            ["node-2"],
        ))
    if kind == "overloaded_ends":
        return Twin(_overload(jax_topologies.grid(3), ["node-0", "node-8"]))
    if kind == "asymmetric":
        # per-direction metrics: d(a -> b) != d(b -> a); the reversed
        # sweep must use each edge's FORWARD metric
        twin = Twin(jax_topologies.ring(6, metric=1))
        db = twin.adj("node-0")
        twin.set_adj(replace(db, adjacencies=tuple(
            replace(a, metric=7) for a in db.adjacencies
        )))
        return twin
    raise ValueError(kind)


KINDS = [
    "grid", "ring", "mesh0", "mesh1", "mesh2", "fat_tree",
    "overloaded_transit", "overloaded_ends", "asymmetric",
]


@pytest.fixture
def jax_impl():
    """Run the reference sweep with a chosen relax implementation,
    restored afterwards. Its block executable is cached by shape, not by
    implementation, so the cache is cleared around the switch."""
    before = jax_sparse.get_ell_relax_impl()

    def use(impl):
        jax_sweep._route_block.clear_cache()
        jax_sparse.set_ell_relax_impl(impl)

    yield use
    jax_sparse.set_ell_relax_impl(before)
    jax_sweep._route_block.clear_cache()


def _names(twin):
    return sorted(twin.ls.get_adjacency_databases())


def _same_product(got, want):
    for field in FIELDS:
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)


def _oracle_routes(ls, src):
    return {
        dst: (res.metric, set(res.next_hops))
        for dst, res in ls.run_spf(src).items()
        if dst != src
    }


def _oracle_digests(ls, graph):
    """``host_digest`` over the host Dijkstra from every source, in the
    graph's node order."""
    n, n_pad = graph.n, graph.n_pad
    d_rows = np.full((n, n_pad), INF, dtype=np.int64)
    nh_counts = np.zeros((n, n_pad), dtype=np.int64)
    for s, s_name in enumerate(graph.node_names):
        for t_name, res in ls.run_spf(s_name).items():
            t = graph.node_index[t_name]
            d_rows[t, s] = res.metric
            if s != t:
                nh_counts[t, s] = len(res.next_hops)
    digests = port_sweep.host_digest(
        d_rows, nh_counts, pos_w=port_sweep.canonical_pos_weights(graph)
    )
    return digests, nh_counts.sum(1)


@pytest.mark.parametrize("kind", KINDS)
def test_compile_out_ell_matches_field_by_field(kind):
    twin = _network(kind)
    want = jax_sweep.compile_out_ell(twin.jax_ls)
    got = port_sweep.compile_out_ell(twin.ls)
    assert got.direction == want.direction == "out"
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
    assert got.slot_of is None


@pytest.mark.parametrize("kind", KINDS)
def test_sweep_matches_pallas_reference_and_oracle(kind, jax_impl):
    twin = _network(kind)
    names = _names(twin)
    jax_impl("pallas")
    want = jax_sweep.all_sources_route_sweep(twin.jax_ls, names, block=16)
    got = port_sweep.all_sources_route_sweep(twin.ls, names, block=16, device=CPU)
    _same_product(got, want)
    assert got.sample_names == want.sample_names
    np.testing.assert_array_equal(got.sample_ids, want.sample_ids)
    np.testing.assert_array_equal(got.samp_v, want.samp_v)
    np.testing.assert_array_equal(got.samp_w, want.samp_w)
    for src in names:
        assert got.routes_from(src) == _oracle_routes(twin.ls, src), src
        assert got.routes_from(src) == want.routes_from(src), src
    assert all(v == 0 for v in LAUNCHES.values())


@pytest.mark.parametrize("kind", ["mesh1", "overloaded_transit", "fat_tree"])
def test_digests_match_host_dijkstra(kind):
    twin = _network(kind)
    graph = port_sweep.compile_out_ell(twin.ls)
    result = port_sweep.RouteSweeper(graph, [graph.node_names[0]], device=CPU).sweep(
        block=32
    )
    digests, nh_totals = _oracle_digests(twin.ls, graph)
    np.testing.assert_array_equal(result.digests[: graph.n], digests)
    np.testing.assert_array_equal(result.nh_totals[: graph.n], nh_totals)


@pytest.mark.parametrize("block", [8, 32, 64])
def test_block_size_does_not_change_the_product(block, jax_impl):
    twin = _network("overloaded_transit")
    names = _names(twin)[:3]
    jax_impl("jnp")
    want = jax_sweep.all_sources_route_sweep(twin.jax_ls, names, block=block)
    got = port_sweep.all_sources_route_sweep(twin.ls, names, block=block, device=CPU)
    _same_product(got, want)
    ref = port_sweep.all_sources_route_sweep(twin.ls, names, block=16, device=CPU)
    _same_product(got, ref)


def test_sweeper_on_carried_reference_bands():
    # the reference's compiled out-ELL, carried as numpy, sweeps to the
    # reference's product; each block records its relax hops
    twin = _network("fat_tree")
    graph = jax_sweep.compile_out_ell(twin.jax_ls)
    port_graph = carry.out_ell_from_numpy(
        graph.node_names, [(b.start, b.rows, b.k) for b in graph.bands],
        graph.src, graph.w, graph.overloaded,
    )
    samples = [graph.node_names[0], graph.node_names[-1]]
    sweeper = port_sweep.RouteSweeper(port_graph, samples, device=CPU)
    got = sweeper.sweep(block=16)
    want = jax_sweep.RouteSweeper(graph, samples).sweep(block=16)
    _same_product(got, want)
    assert len(sweeper.block_hops) == -(-graph.n_pad // 16)
    assert all(1 <= h <= graph.n_pad for h in sweeper.block_hops)
    assert port_sweep.digests_by_name(got) == jax_sweep.digests_by_name(want)


def test_packed_block_layout_matches_reference():
    twin = _network("overloaded_ends")
    graph = jax_sweep.compile_out_ell(twin.jax_ls)
    port_graph = port_sweep.compile_out_ell(twin.ls)
    samples = [graph.node_names[1]]
    ids = np.arange(graph.n_pad, dtype=np.int32)[: 2 * graph.n]
    want = np.asarray(jax_sweep.RouteSweeper(graph, samples).solve_block(ids))
    got = port_sweep.RouteSweeper(port_graph, samples, device=CPU).solve_block(ids)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_assemble_result_full_and_delta():
    twin = _network("mesh0")
    graph = port_sweep.compile_out_ell(twin.ls)
    samples = [graph.node_names[2]]
    sweeper = port_sweep.RouteSweeper(graph, samples, device=CPU)
    packed = sweeper.solve_block(np.arange(graph.n_pad)).numpy()
    full = port_sweep.assemble_result(sweeper, packed)
    _same_product(full, sweeper.sweep(block=32))
    ids = np.asarray([3, 7, 11])
    stale = port_sweep.assemble_result(sweeper, np.zeros_like(packed))
    delta = np.concatenate([ids[:, None].astype(np.int32), packed[ids]], axis=1)
    port_sweep.assemble_result(sweeper, delta, into=stale)
    np.testing.assert_array_equal(stale.digests[ids], full.digests[ids])
    np.testing.assert_array_equal(stale.sample_masks[ids], full.sample_masks[ids])


def test_digest_helpers_match_reference():
    rng = np.random.default_rng(7)
    d = rng.integers(0, 1 << 30, (5, 300)).astype(np.int32)
    d[rng.random(d.shape) < 0.3] = INF
    nh = rng.integers(0, 700, (5, 300)).astype(np.int32)
    pos_w = rng.integers(0, 1 << 32, 300, dtype=np.uint64).astype(np.uint32)
    want = jax_sweep.host_digest(d, nh, pos_w)
    np.testing.assert_array_equal(port_sweep.host_digest(d, nh, pos_w), want)
    np.testing.assert_array_equal(port_sweep.host_digest(d, nh), jax_sweep.host_digest(d, nh))
    got = port_sweep._digest_rows(
        torch.from_numpy(d), torch.from_numpy(nh),
        torch.from_numpy(pos_w.astype(np.int64)),
    )
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    bits = port_sweep._as_int32_bits(got)
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), want)


def test_sweep_rejects_an_in_edge_graph_and_needs_cuda_by_default(monkeypatch):
    twin = _network("ring")
    with pytest.raises(ValueError, match="out-edge"):
        port_sweep.RouteSweeper(port_sparse.compile_ell(twin.ls), ["node-0"], device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_sweep.all_sources_route_sweep(twin.ls, ["node-0"])
