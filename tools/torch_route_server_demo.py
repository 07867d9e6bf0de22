"""Route-server demo on the port: one resident route engine answering any
served node's whole route table, refreshed incrementally under churn.

The destination-major engine (``openr_tpu_torch/ops/route_engine.py``)
holds the whole network's route product on the device: every node named
as a sample gets its complete route table assembled from the product,
and a churn event re-solves only the affected destinations and reads
back only the rows that changed. The demo builds a fat tree from
synthetic adjacency databases, serves three rack switches' tables,
applies a metric change and then a link failure, and checks the first
served table against the host Dijkstra (``LinkState.run_spf``) after
each event.

Run:  python -m tools.torch_route_server_demo [--nodes 336] [--grouped]
          [--device cpu]

The last line of the output is one JSON object: the backend, the
nodes, each event's moved destinations and host ms, the cold builds and
whether every check held.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import replace

EVENTS = ("metric", "link-down")


def _check(ls, engine, served) -> int:
    oracle = ls.run_spf(served)
    got = engine.result.routes_from(served)
    for dst, (metric, nhs) in got.items():
        want = oracle.get(dst)
        if want is None or metric != want.metric or nhs != set(want.next_hops):
            raise AssertionError(f"{served} -> {dst}: {metric, nhs} != oracle")
    # every reachable destination is served (the oracle holds the source)
    if len(got) != len(oracle) - 1:
        raise AssertionError(f"{served}: {len(got)} routes, oracle {len(oracle) - 1}")
    return len(got)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--nodes", type=int, default=336)
    p.add_argument("--grouped", action="store_true",
                   help="the block-bipartite grouped backend")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    from openr_tpu_torch.device import resolve_device
    from openr_tpu_torch.graph.linkstate import LinkState
    from openr_tpu_torch.models import topologies
    from openr_tpu_torch.ops import route_engine

    device = resolve_device(args.device)
    topo = topologies.fat_tree_nodes(args.nodes)
    ls = LinkState(area=topo.area)
    for name in sorted(topo.adj_dbs):
        ls.update_adjacency_database(topo.adj_dbs[name])
    names = sorted(topo.adj_dbs)
    served = [n for n in names if n.startswith("rsw")][:3]
    if args.grouped:
        engine = route_engine.GroupedRouteSweepEngine(ls, served, device=device)
    else:
        engine = route_engine.RouteSweepEngine(ls, served, device=device)
    backend = "grouped" if args.grouped else "ell"
    print(f"resident build: {len(names)} nodes, serving {len(served)} full tables "
          f"({backend} backend, {device})")
    checked = _check(ls, engine, served[0])
    print(f"{served[0]}: {checked} destinations, oracle parity exact")

    fsw = next(n for n in names if n.startswith("fsw"))
    event_ms, moved_counts = [], []
    for what in EVENTS:
        db = ls.get_adjacency_databases()[fsw]
        adjs = list(db.adjacencies)
        if what == "link-down":
            # both ends withdraw the adjacency
            dropped = adjs.pop(0)
            ls.update_adjacency_database(replace(db, adjacencies=tuple(adjs)))
            odb = ls.get_adjacency_databases()[dropped.other_node_name]
            ls.update_adjacency_database(replace(odb, adjacencies=tuple(
                a for a in odb.adjacencies if a.other_node_name != fsw)))
            affected = {fsw, dropped.other_node_name}
        else:
            adjs[0] = replace(adjs[0], metric=7)
            ls.update_adjacency_database(replace(db, adjacencies=tuple(adjs)))
            affected = {fsw, adjs[0].other_node_name}
        t0 = time.perf_counter()
        moved = engine.churn(ls, affected)
        ms = (time.perf_counter() - t0) * 1e3
        event_ms.append(ms)
        moved_counts.append(None if moved is None else len(moved))
        if moved is None:
            print(f"{what} event: cold rebuild in {ms:.1f} ms")
        else:
            print(f"{what} event: {len(moved)} destinations refreshed in {ms:.1f} ms "
                  f"({engine.last_path}; {engine.cold_builds} build(s) total)")
        checked = _check(ls, engine, served[0])
    print(f"oracle parity: {checked} routes of {served[0]} exact (metrics + ECMP sets)")
    print(json.dumps({
        "backend": backend, "nodes": len(names), "device": str(device),
        "events": list(EVENTS), "moved": moved_counts, "event_ms": event_ms,
        "cold_builds": engine.cold_builds, "parity": True,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
