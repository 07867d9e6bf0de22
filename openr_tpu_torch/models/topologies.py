"""Synthetic topology generators: the framework's "model zoo".

Port note: a copy of ``openr_tpu/models/topologies.py``; nothing left out.

Produces AdjacencyDatabase / PrefixDatabase sets for the same topology
families the reference benchmarks against (reference:
openr/decision/tests/RoutingBenchmarkUtils.cpp — createGrid:205,
createFabric:356) plus rings and random regular meshes for fuzzing.

All generators are deterministic given their arguments.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from openr_tpu_torch.types import (
    Adjacency,
    AdjacencyDatabase,
    BinaryAddress,
    IpPrefix,
    PrefixDatabase,
    PrefixEntry,
)
from openr_tpu_torch.types.lsdb import PrefixForwardingAlgorithm, PrefixForwardingType


@dataclass
class Topology:
    """A fully-formed synthetic network: per-node adjacency + prefix DBs."""

    name: str
    area: str = "0"
    adj_dbs: Dict[str, AdjacencyDatabase] = field(default_factory=dict)
    prefix_dbs: Dict[str, PrefixDatabase] = field(default_factory=dict)

    @property
    def num_nodes(self) -> int:
        return len(self.adj_dbs)

    def nodes(self) -> List[str]:
        return sorted(self.adj_dbs)


def _iface(a: str, b: str, k: int = 0) -> str:
    # k numbers parallel links (LAG members) between the same pair;
    # k=0 keeps the historical single-link name
    return f"if_{a}_{b}" if k == 0 else f"if_{a}_{b}_{k}"


def _v6(node_idx: int, peer_idx: int) -> BinaryAddress:
    # unique link-local-style v6 address per directed link
    hi = (0xFE80 << 112) | (node_idx << 32) | peer_idx
    return BinaryAddress(addr=hi.to_bytes(16, "big"))


def _v4(node_idx: int, peer_idx: int) -> BinaryAddress:
    val = (10 << 24) | ((node_idx & 0xFFF) << 12) | (peer_idx & 0xFFF)
    return BinaryAddress(addr=val.to_bytes(4, "big"))


def _mk_adj(
    a: str,
    ai: int,
    b: str,
    bi: int,
    metric: int,
    adj_label: int = 0,
    overloaded: bool = False,
    link_idx: int = 0,
) -> Adjacency:
    return Adjacency(
        other_node_name=b,
        if_name=_iface(a, b, link_idx),
        other_if_name=_iface(b, a, link_idx),
        metric=metric,
        next_hop_v6=_v6(bi, ai),
        next_hop_v4=_v4(bi, ai),
        adj_label=adj_label,
        is_overloaded=overloaded,
    )


def _loopback_prefix(node_idx: int, v4: bool = False) -> IpPrefix:
    if v4:
        val = (172 << 24) | (16 << 16) | node_idx
        return IpPrefix(BinaryAddress(addr=val.to_bytes(4, "big")), 32)
    val = (0xFD00 << 112) | node_idx
    return IpPrefix(BinaryAddress(addr=val.to_bytes(16, "big")), 128)


def build_topology(
    name: str,
    edges: List[Tuple[str, str, int]],
    area: str = "0",
    forwarding_algorithm: PrefixForwardingAlgorithm = (
        PrefixForwardingAlgorithm.SP_ECMP
    ),
    forwarding_type: PrefixForwardingType = PrefixForwardingType.IP,
    node_labels: bool = True,
    v4_prefixes: bool = False,
) -> Topology:
    """Build a Topology from an undirected edge list (a, b, metric)."""
    names = sorted({n for e in edges for n in e[:2]})
    idx = {n: i for i, n in enumerate(names)}
    neighbors: Dict[str, List[Adjacency]] = {n: [] for n in names}
    # duplicate (a, b) pairs are PARALLEL links (LAG members): each
    # occurrence gets its own numbered interface pair so the LinkState
    # models them as first-class Links (reference: LinkState.h:82)
    pair_count: Dict[Tuple[str, str], int] = {}
    for a, b, metric in edges:
        pair = (a, b) if a < b else (b, a)
        k = pair_count.get(pair, 0)
        pair_count[pair] = k + 1
        neighbors[a].append(
            _mk_adj(a, idx[a], b, idx[b], metric, link_idx=k)
        )
        neighbors[b].append(
            _mk_adj(b, idx[b], a, idx[a], metric, link_idx=k)
        )

    topo = Topology(name=name, area=area)
    for n in names:
        topo.adj_dbs[n] = AdjacencyDatabase(
            this_node_name=n,
            adjacencies=tuple(neighbors[n]),
            node_label=idx[n] + 101 if node_labels else 0,
            area=area,
        )
        topo.prefix_dbs[n] = PrefixDatabase(
            this_node_name=n,
            prefix_entries=(
                PrefixEntry(
                    prefix=_loopback_prefix(idx[n], v4=v4_prefixes),
                    forwarding_algorithm=forwarding_algorithm,
                    forwarding_type=forwarding_type,
                ),
            ),
            area=area,
        )
    return topo


def grid(
    n: int,
    metric: int = 1,
    area: str = "0",
    forwarding_algorithm: PrefixForwardingAlgorithm = (
        PrefixForwardingAlgorithm.SP_ECMP
    ),
    forwarding_type: PrefixForwardingType = PrefixForwardingType.IP,
) -> Topology:
    """n x n grid. reference: RoutingBenchmarkUtils.cpp createGrid:205."""
    edges: List[Tuple[str, str, int]] = []

    def node(r: int, c: int) -> str:
        return f"node-{r * n + c}"

    for r in range(n):
        for c in range(n):
            if c + 1 < n:
                edges.append((node(r, c), node(r, c + 1), metric))
            if r + 1 < n:
                edges.append((node(r, c), node(r + 1, c), metric))
    return build_topology(
        f"grid-{n}x{n}",
        edges,
        area=area,
        forwarding_algorithm=forwarding_algorithm,
        forwarding_type=forwarding_type,
    )


def fat_tree(
    pods: int,
    ssw_per_plane: int = 4,
    fsw_per_pod: int = 4,
    rsw_per_pod: int = 12,
    area: str = "0",
    forwarding_algorithm: PrefixForwardingAlgorithm = (
        PrefixForwardingAlgorithm.SP_ECMP
    ),
    forwarding_type: PrefixForwardingType = PrefixForwardingType.IP,
) -> Topology:
    """3-tier fat-tree/fabric: spine (SSW) planes, fabric (FSW) per pod,
    rack (RSW) per pod. Wiring mirrors the reference fabric generator:
    every FSW k in a pod uplinks to every SSW in plane k; every RSW in a
    pod connects to every FSW in its pod.
    reference: RoutingBenchmarkUtils.h:53-58, createFabric:356.
    """
    edges: List[Tuple[str, str, int]] = []
    for pod in range(pods):
        for k in range(fsw_per_pod):
            fsw = f"fsw-{pod}-{k}"
            for s in range(ssw_per_plane):
                edges.append((f"ssw-{k}-{s}", fsw, 1))
            for rr in range(rsw_per_pod):
                edges.append((fsw, f"rsw-{pod}-{rr}", 1))
    return build_topology(
        f"fat-tree-p{pods}",
        edges,
        area=area,
        forwarding_algorithm=forwarding_algorithm,
        forwarding_type=forwarding_type,
    )


def fat_tree_nodes(
    target_nodes: int, **kwargs
) -> Topology:
    """Pick pod count so total node count is close to ``target_nodes``."""
    ssw_per_plane = kwargs.get("ssw_per_plane", 4)
    fsw_per_pod = kwargs.get("fsw_per_pod", 4)
    rsw_per_pod = kwargs.get("rsw_per_pod", 12)
    spine = ssw_per_plane * fsw_per_pod
    per_pod = fsw_per_pod + rsw_per_pod
    pods = max(1, round((target_nodes - spine) / per_pod))
    return fat_tree(pods, **kwargs)


def ring(n: int, metric: int = 1, area: str = "0") -> Topology:
    edges = [(f"node-{i}", f"node-{(i + 1) % n}", metric) for i in range(n)]
    return build_topology(f"ring-{n}", edges, area=area)


def random_mesh(
    n: int,
    degree: int = 4,
    seed: int = 0,
    max_metric: int = 100,
    area: str = "0",
) -> Topology:
    """Connected random graph with random metrics: the fuzzing workhorse."""
    rng = random.Random(seed)
    edges: List[Tuple[str, str, int]] = []
    seen = set()

    def add(i: int, j: int) -> None:
        if i == j:
            return
        key = (min(i, j), max(i, j))
        if key in seen:
            return
        seen.add(key)
        edges.append((f"node-{i}", f"node-{j}", rng.randint(1, max_metric)))

    # random spanning tree for connectivity
    order = list(range(n))
    rng.shuffle(order)
    for k in range(1, n):
        add(order[k], order[rng.randrange(k)])
    # extra random edges up to target degree
    target_edges = n * degree // 2
    attempts = 0
    while len(edges) < target_edges and attempts < 20 * target_edges:
        add(rng.randrange(n), rng.randrange(n))
        attempts += 1
    return build_topology(f"mesh-{n}-d{degree}-s{seed}", edges, area=area)
