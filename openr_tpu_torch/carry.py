"""State carried into the port from plain data, and route databases out.

The "weights" of a route build are its inputs and compiled graph state:
the link-state and prefix databases, the dense snapshot, the sliced-ELL
bands (in-edge and out-edge), the grouped segments, the KSP2 exclusion
sets and a KSP2 engine's cached paths (as link keys). These functions build the port's objects from plain
Python data and numpy arrays, so any producer (a file, another
implementation, a test) can hand state to the port without sharing a type
with it, and turn a ``RouteDatabase`` into a canonical plain form for
comparison.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.graph.snapshot import GraphSnapshot
from openr_tpu_torch.ops.spf_grouped import GridBand, GroupedGraph, Segment
from openr_tpu_torch.ops.spf_sparse import EllBand, EllGraph, link_key
from openr_tpu_torch.types import (
    Adjacency,
    AdjacencyDatabase,
    BinaryAddress,
    IpPrefix,
    PerfEvent,
    PerfEvents,
    PrefixDatabase,
    PrefixEntry,
    PrefixMetrics,
    PrefixType,
)
from openr_tpu_torch.types.lsdb import (
    CompareType,
    MetricEntity,
    MetricVector,
    PrefixForwardingAlgorithm,
    PrefixForwardingType,
)


def to_plain(obj):
    """Any tree of dataclasses, enums, tuples and lists as plain data:
    the ``dataclasses.asdict`` form with enums as their values and
    tuples as lists. Works on objects of any package by their fields."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: to_plain(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [to_plain(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_plain(v) for k, v in obj.items()}
    return obj


def _address(d) -> BinaryAddress:
    return BinaryAddress(addr=d["addr"], if_name=d["if_name"])


def _perf_events(d):
    if d is None:
        return None
    return PerfEvents(events=[PerfEvent(**e) for e in d["events"]])


def _adjacency(d) -> Adjacency:
    return Adjacency(
        **{
            **d,
            "next_hop_v6": _address(d["next_hop_v6"]),
            "next_hop_v4": _address(d["next_hop_v4"]),
        }
    )


def _metric_vector(d):
    if d is None:
        return None
    return MetricVector(
        version=d["version"],
        metrics=tuple(
            MetricEntity(
                type=m["type"],
                priority=m["priority"],
                op=CompareType(m["op"]),
                is_best_path_tie_breaker=m["is_best_path_tie_breaker"],
                metric=tuple(m["metric"]),
            )
            for m in d["metrics"]
        ),
    )


def _prefix_entry(d) -> PrefixEntry:
    return PrefixEntry(
        prefix=IpPrefix(
            prefix_address=_address(d["prefix"]["prefix_address"]),
            prefix_length=d["prefix"]["prefix_length"],
        ),
        type=PrefixType(d["type"]),
        forwarding_type=PrefixForwardingType(d["forwarding_type"]),
        forwarding_algorithm=PrefixForwardingAlgorithm(
            d["forwarding_algorithm"]
        ),
        min_nexthop=d["min_nexthop"],
        prepend_label=d["prepend_label"],
        mv=_metric_vector(d["mv"]),
        metrics=PrefixMetrics(**d["metrics"]),
        tags=tuple(d["tags"]),
        area_stack=tuple(d["area_stack"]),
        data=d["data"],
    )


def lsdb_from_plain(
    adj_dbs: Iterable[dict], prefix_dbs: Iterable[dict]
) -> Tuple[List[AdjacencyDatabase], List[PrefixDatabase]]:
    """The port's adjacency and prefix databases from their plain form
    (``to_plain`` of either package's objects)."""
    adjs = [
        AdjacencyDatabase(
            this_node_name=d["this_node_name"],
            is_overloaded=d["is_overloaded"],
            adjacencies=tuple(_adjacency(a) for a in d["adjacencies"]),
            node_label=d["node_label"],
            area=d["area"],
            perf_events=_perf_events(d["perf_events"]),
        )
        for d in adj_dbs
    ]
    prefixes = [
        PrefixDatabase(
            this_node_name=d["this_node_name"],
            prefix_entries=tuple(_prefix_entry(e) for e in d["prefix_entries"]),
            delete_prefix=d["delete_prefix"],
            area=d["area"],
            perf_events=_perf_events(d["perf_events"]),
        )
        for d in prefix_dbs
    ]
    return adjs, prefixes


def snapshot_from_numpy(
    node_names: Sequence[str],
    metric: np.ndarray,
    overloaded: np.ndarray,
    device: DeviceLike = None,
) -> GraphSnapshot:
    """A dense ``GraphSnapshot`` with its tensors on ``device`` (None =
    CUDA) from a padded ``metric [n_pad, n_pad]`` int32 matrix and an
    ``overloaded [n_pad]`` mask. Host link metadata is not carried:
    ``links_from`` is empty, so build source batches from explicit ids."""
    metric = np.ascontiguousarray(metric, dtype=np.int32)
    overloaded = np.ascontiguousarray(overloaded, dtype=bool)
    names = list(node_names)
    if metric.shape != (overloaded.shape[0],) * 2 or len(names) > metric.shape[0]:
        raise ValueError(
            f"metric {metric.shape}, overloaded {overloaded.shape}, "
            f"{len(names)} names"
        )
    snap = GraphSnapshot(
        area="",
        version=0,
        node_names=names,
        node_index={name: i for i, name in enumerate(names)},
        n=len(names),
        n_pad=metric.shape[0],
        metric=metric,
        overloaded=overloaded,
        links_from=[[] for _ in names],
    )
    snap.device_arrays(resolve_device(device))
    return snap


def ell_from_numpy(
    node_names: Sequence[str],
    bands: Sequence[Tuple[int, int, int]],
    src: Sequence[np.ndarray],
    w: Sequence[np.ndarray],
    overloaded: np.ndarray,
) -> EllGraph:
    """An ``EllGraph`` from its bands ``[(start, rows, k)]`` and the
    per-band ``[rows, k]`` int32 slot arrays. The graph is host state;
    ``ell_view_batch_packed`` moves it to the device it solves on."""
    names = tuple(node_names)
    ebands = tuple(EllBand(int(s), int(r), int(k)) for s, r, k in bands)
    srcs = tuple(np.ascontiguousarray(a, dtype=np.int32) for a in src)
    ws = tuple(np.ascontiguousarray(a, dtype=np.int32) for a in w)
    for band, s_b, w_b in zip(ebands, srcs, ws):
        if s_b.shape != (band.rows, band.k) or w_b.shape != s_b.shape:
            raise ValueError(f"band {band}: src {s_b.shape}, w {w_b.shape}")
    return EllGraph(
        node_names=names,
        node_index={name: i for i, name in enumerate(names)},
        n=len(names),
        n_pad=int(overloaded.shape[0]),
        bands=ebands,
        src=srcs,
        w=ws,
        overloaded=np.ascontiguousarray(overloaded, dtype=bool),
    )


def out_ell_from_numpy(
    node_names: Sequence[str],
    bands: Sequence[Tuple[int, int, int]],
    v: Sequence[np.ndarray],
    w: Sequence[np.ndarray],
    overloaded: np.ndarray,
) -> EllGraph:
    """An out-edge ``EllGraph`` (row j holds the edges out of j, as the
    route sweep relaxes them) from its bands and per-band ``[rows, k]``
    int32 neighbour and metric arrays; a ``RouteSweeper`` moves it to the
    device it solves on."""
    graph = ell_from_numpy(node_names, bands, v, w, overloaded)
    return dataclasses.replace(graph, direction="out")


def grouped_from_numpy(
    node_names: Sequence[str],
    bands: Sequence[Tuple[int, int, int, Sequence[Tuple[int, np.ndarray, np.ndarray]]]],
    overloaded: np.ndarray,
    direction: str,
) -> GroupedGraph:
    """A ``GroupedGraph`` from its bands ``[(start, g1, g2, segments)]``,
    each segment ``(axis, src [G, S], w [G, S, R])`` int32. The graph is
    host state; a ``GroupedState`` or ``GroupedRouteSweeper`` moves it to
    the device it solves on."""
    names = tuple(node_names)
    gbands = []
    pos = 0
    for start, g1, g2, segments in bands:
        if int(start) != pos:
            raise ValueError(f"band at {start} does not start at node {pos}")
        segs = []
        for axis, src, w in segments:
            src = np.ascontiguousarray(src, dtype=np.int32)
            w = np.ascontiguousarray(w, dtype=np.int32)
            groups = int(g1) if axis == 1 else int(g2)
            members = int(g2) if axis == 1 else int(g1)
            if w.shape != (groups, src.shape[1], members) or src.shape[0] != groups:
                raise ValueError(
                    f"segment axis {axis} of a {g1}x{g2} band: src "
                    f"{src.shape}, w {w.shape}"
                )
            segs.append(Segment(axis=int(axis), src=src, w=w))
        gbands.append(GridBand(int(start), int(g1), int(g2), tuple(segs)))
        pos += int(g1) * int(g2)
    if pos != len(names):
        raise ValueError(f"bands cover {pos} of {len(names)} nodes")
    return GroupedGraph(
        node_names=names,
        node_index={name: i for i, name in enumerate(names)},
        n=len(names),
        n_pad=int(overloaded.shape[0]),
        bands=tuple(gbands),
        overloaded=np.ascontiguousarray(overloaded, dtype=bool),
        direction=direction,
    )


def links_from_keys(ls, key_sets) -> List[set]:
    """Per set of plain link keys (``spf_sparse.link_key``: a link's
    (node, iface) pair tuple, the same in either package), the set of
    ``ls``'s own ``Link`` objects, as ``build_edge_masks`` takes them. A
    key that names no link of ``ls`` raises."""
    by_key = {link_key(link): link for link in ls.all_links()}
    return [{by_key[tuple(key)] for key in keys} for keys in key_sets]


def paths_to_keys(paths_by_dst) -> dict:
    """A KSP2 engine's cached paths (``{destination: [path]}``, a path a
    list of ``Link``s of either package) as plain link keys
    (``spf_sparse.link_key``), for comparison destination by
    destination."""
    return {
        dst: [[link_key(link) for link in path] for path in paths]
        for dst, paths in paths_by_dst.items()
    }


def _freeze(x):
    if isinstance(x, dict):
        return tuple((k, _freeze(v)) for k, v in sorted(x.items()))
    if isinstance(x, list):
        return tuple(_freeze(v) for v in x)
    return x


def route_db_to_plain(route_db) -> tuple:
    """A canonical nested-tuple form of a ``RouteDatabase`` (of either
    package): routes sorted by destination / label, next hops sorted.
    Two equal route databases give equal tuples."""

    def route(r) -> tuple:
        d = to_plain(r)
        hops = sorted((_freeze(h) for h in d.pop("next_hops")), key=repr)
        return (_freeze(d), tuple(hops))

    return (
        route_db.this_node_name,
        tuple(sorted((route(r) for r in route_db.unicast_routes), key=repr)),
        tuple(sorted((route(r) for r in route_db.mpls_routes), key=repr)),
    )
