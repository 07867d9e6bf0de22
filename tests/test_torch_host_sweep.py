"""The port's host route product (``ops/host_sweep.py``, the route
engine's host rung) against the JAX package's, byte for byte, and
against the port's own sweep on CPU tensors.

The same networks (the reference tests' topologies, and ones with
overloaded transit and end nodes) go through ``openr_tpu.ops.host_sweep``
and the port's copy: the compiled out-bands, every block's fixed point,
next-hop counts and sample statistics, and the whole packed product must
be equal, and ``assemble_result`` over the port's product must equal a
cold ``RouteSweeper`` sweep (``device="cpu"``).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

from openr_tpu.models import topologies as jax_topologies
from openr_tpu.ops import host_sweep as jax_host
from openr_tpu.ops import route_sweep as jax_sweep
from openr_tpu_torch.ops import host_sweep as port_host
from openr_tpu_torch.ops import route_sweep as port_sweep
from tests.test_torch_solver import Twin


def _overload(topo, names):
    for name in names:
        topo.adj_dbs[name] = replace(topo.adj_dbs[name], is_overloaded=True)
    return topo


NETWORKS = {
    "ring": lambda: jax_topologies.ring(16),
    "fat_tree": lambda: jax_topologies.fat_tree(pods=3, ssw_per_plane=2, fsw_per_pod=2,
                                                rsw_per_pod=4),
    "mesh": lambda: jax_topologies.random_mesh(24, degree=3, seed=7, max_metric=9),
    "overloaded": lambda: _overload(
        jax_topologies.random_mesh(18, degree=4, seed=5, max_metric=9),
        ["node-2", "node-0", "node-9"]),
}


def _samples(twin):
    names = sorted(twin.ls.get_adjacency_databases())
    return [names[0], names[len(names) // 2], names[-1]]


@pytest.mark.parametrize("net", sorted(NETWORKS))
@pytest.mark.parametrize("align,block", [(128, 256), (16, 7)])
def test_host_route_product_matches_reference_byte_for_byte(net, align, block):
    twin = Twin(NETWORKS[net]())
    samples = _samples(twin)
    j_shim, j_packed = jax_host.host_route_product(twin.jax_ls, samples, align=align,
                                                   block=block)
    p_shim, p_packed = port_host.host_route_product(twin.ls, samples, align=align,
                                                    block=block)
    assert p_packed.dtype == j_packed.dtype == np.int32
    assert p_packed.tobytes() == j_packed.tobytes()
    assert tuple(p_shim.graph.node_names) == tuple(j_shim.graph.node_names)
    assert p_shim.sample_names == j_shim.sample_names
    np.testing.assert_array_equal(p_shim.sample_ids, j_shim.sample_ids)
    np.testing.assert_array_equal(p_shim.samp_v, j_shim.samp_v)
    np.testing.assert_array_equal(p_shim.samp_w, j_shim.samp_w)
    got = port_sweep.assemble_result(p_shim, p_packed)
    want = jax_sweep.assemble_result(j_shim, j_packed)
    for s in samples:
        assert got.routes_from(s) == want.routes_from(s)


@pytest.mark.parametrize("net", sorted(NETWORKS))
def test_block_kernels_match_reference(net):
    twin = Twin(NETWORKS[net]())
    samples = _samples(twin)
    graph = port_sweep.compile_out_ell(twin.ls)
    ov = np.asarray(graph.overloaded, dtype=bool)
    t_ids = np.arange(0, graph.n_pad, 5, dtype=np.int32)
    dr_p = port_host._block_fixed_point(graph, ov, t_ids)
    dr_j = jax_host._block_fixed_point(graph, ov, t_ids)
    np.testing.assert_array_equal(dr_p, dr_j)
    np.testing.assert_array_equal(port_host._block_nh_counts(graph, ov, dr_p, t_ids),
                                  jax_host._block_nh_counts(graph, ov, dr_j, t_ids))
    ids = np.asarray([graph.node_index[s] for s in samples], dtype=np.int32)
    sv, sw = port_sweep._sample_bands(graph, ids)
    for got, want in zip(port_host._block_sample_stats(dr_p, ids, sv, sw, ov, t_ids),
                         jax_host._block_sample_stats(dr_j, ids, sv, sw, ov, t_ids)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("net", sorted(NETWORKS))
def test_host_product_equals_the_port_sweep(net):
    twin = Twin(NETWORKS[net]())
    samples = _samples(twin)
    shim, packed = port_host.host_route_product(twin.ls, samples, block=64)
    host = port_sweep.assemble_result(shim, packed)
    dev = port_sweep.all_sources_route_sweep(twin.ls, samples, block=64,
                                             device=torch.device("cpu"))
    for f in ("digests", "nh_totals", "sample_metrics", "sample_masks"):
        np.testing.assert_array_equal(getattr(host, f), getattr(dev, f), err_msg=f)
