"""Multi-process clients of the solver service.

The load harness (``load.harness``) drives one in-process pipeline; this module
drives a ``SolverService`` the way production would be driven — N
OS-process client daemons, each owning a disjoint set of tenants,
registering worlds, churning metrics, and soliciting views over the
ctrl wire. Child processes are TORCH-FREE (serve/client.py + the
topology generators only), so spawn startup is milliseconds and the
one device owner stays the service process.

Everything is deterministic from the spec: the world a tenant
registers and the metric it churns on round ``i`` derive only from
``(spec, i)``, so a parent (test or smoke gate) replays the same
schedule host-side to produce oracle digests without any channel back
from the children beyond the result files.

``run_client`` is module-level and takes only picklable arguments —
required by the ``spawn`` start method (the only safe method with a
parent that holds a CUDA context).

Port note: a copy of ``openr_tpu/load/multi_client.py``; the oracles
(``oracle_digests``, ``oracle_fib_digests``) take the ``device`` their
sequential solves run on, and ``main`` the service's.
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, replace
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's deterministic world + churn schedule."""

    tenant_id: str
    kind: str          # "grid" | "ring" | "mesh" | "fabric"
    size: int
    seed: int = 0
    slo: str = "standard"

    def build_topology(self):
        from openr_tpu_torch.models import topologies

        if self.kind == "grid":
            return topologies.grid(self.size)
        if self.kind == "ring":
            return topologies.ring(self.size)
        if self.kind == "mesh":
            return topologies.random_mesh(
                self.size, 3, seed=self.seed or 7
            )
        if self.kind == "fabric":
            # the port's addition: a fat tree of about ``size`` nodes
            # (``fat_tree_nodes``), the fabric a route server serves
            return topologies.fat_tree_nodes(self.size)
        raise ValueError(f"unknown topology kind {self.kind!r}")

    def build_dbs(self) -> Dict[str, "object"]:
        return dict(self.build_topology().adj_dbs)

    def build_prefix_dbs(self) -> Dict[str, "object"]:
        """Per-node loopback PrefixDatabases — what the FIB-level view
        routes toward (static across the churn schedule: mutations
        touch adjacency metrics only)."""
        return dict(self.build_topology().prefix_dbs)

    def root_of(self, dbs: Dict) -> str:
        return sorted(dbs)[0]

    def mutation(self, dbs: Dict, round_i: int) -> Tuple[str, object]:
        """The round's churn: ONE adjacency metric bump on a
        deterministically chosen node. Returns (node, new_db); pure —
        parent oracles replay it bit-identically."""
        names = sorted(dbs)
        node = names[(round_i * 3 + self.seed) % len(names)]
        db = dbs[node]
        adjs = list(db.adjacencies)
        if not adjs:
            node = names[0]
            db = dbs[node]
            adjs = list(db.adjacencies)
        ai = (round_i + self.seed) % len(adjs)
        metric = 1 + ((round_i * 7 + self.seed * 5 + ai) % 13)
        adjs[ai] = replace(adjs[ai], metric=metric)
        return node, replace(db, adjacencies=tuple(adjs))


def apply_mutation(dbs: Dict, spec: TenantSpec, round_i: int) -> str:
    """Mutate ``dbs`` in place per the schedule; returns the node."""
    node, db = spec.mutation(dbs, round_i)
    dbs[node] = db
    return node


def run_client(
    host: str,
    port: int,
    client_id: str,
    specs: List[Dict],
    rounds: int,
    out_path: str,
    ksp2_every: int = 0,
    hold_open_s: float = 0.0,
    endpoints: Dict[str, List] = None,
    controller: List = None,
    fib_every: int = 0,
) -> None:
    """Child-process entry: drive ``specs``' tenants for ``rounds``
    churn rounds and write a JSON result file — per-request latencies
    (by SLO class), the per-tenant view digest after every round, and
    any errors. ``ksp2_every > 0`` also solicits the second-path view
    every that-many rounds (digested as the JSON text of the reply).
    ``hold_open_s`` keeps the connection (and its tenants) alive after
    the last round — the disconnect tests use it.

    Fleet mode: ``endpoints`` maps tenant_id -> [host, port] (the
    controller's admission decisions; tenants without an entry use the
    default endpoint), ``controller`` is the fleet controller's
    [host, port] for lookup fallback after an endpoint dies, and
    ``fib_every > 0`` also consumes the FIB-level view (full
    RouteDatabase digest) every that-many rounds. The client rides
    migrations and promotions transparently — redirect/reconnect
    totals land in the result for the parity gates."""
    from openr_tpu_torch.serve.client import SolverClient

    result = {
        "client_id": client_id,
        "latencies_ms": {},
        "digests": {},
        "ksp2": {},
        "fib": {},
        "errors": [],
        "rounds": 0,
        "trace_id": None,
        "span_ids": [],
        "redirects": 0,
        "reconnects": 0,
    }
    clients: Dict[tuple, SolverClient] = {}
    ctrl_ep = tuple(controller) if controller else None

    def client_for(tid: str) -> SolverClient:
        ep = (host, port)
        if endpoints and tid in endpoints:
            e = endpoints[tid]
            ep = (str(e[0]), int(e[1]))
        c = clients.get(ep)
        if c is None:
            c = clients[ep] = SolverClient(
                ep[0], ep[1], controller=ctrl_ep
            )
        return c

    try:
        worlds = {}
        for sd in specs:
            spec = TenantSpec(**sd)
            dbs = spec.build_dbs()
            worlds[spec.tenant_id] = (spec, dbs)
            client = client_for(spec.tenant_id)
            # reported back so the parent gate can check cross-wire
            # trace continuity: these ids must surface in the
            # SERVICE's wave flight records
            if result["trace_id"] is None:
                result["trace_id"] = client.trace_id
            client.register(spec.tenant_id, slo=spec.slo)
            client.update_world(
                spec.tenant_id, [dbs[k] for k in sorted(dbs)],
                root=spec.root_of(dbs),
                prefix_dbs=(
                    [
                        db for _k, db in sorted(
                            spec.build_prefix_dbs().items()
                        )
                    ]
                    if fib_every else None
                ),
            )
            result["digests"][spec.tenant_id] = []
            result["ksp2"][spec.tenant_id] = []
            result["fib"][spec.tenant_id] = []
        for i in range(rounds):
            for tid, (spec, dbs) in worlds.items():
                client = client_for(tid)
                if i > 0:
                    node = apply_mutation(dbs, spec, i)
                    client.update_world(tid, [dbs[node]])
                t0 = time.perf_counter()
                view = client.solve(tid)
                ms = (time.perf_counter() - t0) * 1000.0
                result["latencies_ms"].setdefault(
                    spec.slo, []
                ).append(ms)
                result["digests"][tid].append(view.digest())
                if ksp2_every and (i + 1) % ksp2_every == 0:
                    paths = client.ksp2(
                        tid, sorted(view.nodes[:8])
                    )
                    result["ksp2"][tid].append(
                        _digest_text(json.dumps(paths, sort_keys=True))
                    )
                if fib_every and (i + 1) % fib_every == 0:
                    result["fib"][tid].append(
                        client.fib(tid).digest
                    )
            result["rounds"] = i + 1
        for c in clients.values():
            result["span_ids"].extend(list(c.span_ids))
            result["redirects"] += c.redirects
            result["reconnects"] += c.reconnects
        if hold_open_s > 0:
            time.sleep(hold_open_s)
        for c in clients.values():
            c.close()
    except Exception as exc:  # noqa: BLE001 - reported in the artifact
        result["errors"].append(repr(exc))
    with open(out_path, "w") as f:
        json.dump(result, f)


def _digest_text(text: str) -> int:
    h = 0x811C9DC5
    for b in text.encode("utf-8"):
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h


def spawn_clients(
    host: str,
    port: int,
    client_specs: Dict[str, List[TenantSpec]],
    rounds: int,
    out_dir: str,
    ksp2_every: int = 0,
    hold_open_s: float = 0.0,
    endpoints: Dict[str, List] = None,
    controller: List = None,
    fib_every: int = 0,
):
    """Launch one spawn-context process per client; returns
    ``[(proc, out_path)]`` for the parent to join and harvest.
    ``endpoints``/``controller``/``fib_every`` pass through to
    ``run_client`` for the fleet mode."""
    import multiprocessing as mp
    import os

    ctx = mp.get_context("spawn")
    procs = []
    for client_id, specs in client_specs.items():
        out_path = os.path.join(
            out_dir, f"solver_client_{client_id}.json"
        )
        p = ctx.Process(
            target=run_client,
            args=(
                host, port, client_id,
                [asdict(s) for s in specs], rounds, out_path,
            ),
            kwargs=dict(
                ksp2_every=ksp2_every, hold_open_s=hold_open_s,
                endpoints=endpoints, controller=controller,
                fib_every=fib_every,
            ),
            daemon=True,
        )
        p.start()
        procs.append((p, out_path))
    return procs


def oracle_digests(
    specs: List[TenantSpec], rounds: int, device=None
) -> Dict[str, List[int]]:
    """Sequential single-graph oracle for the exact schedule
    ``run_client`` drives: per tenant, per round, the FNV digest of
    ``ell_view_batch_packed`` over the replayed world on ``device``
    (None = CUDA). Imports torch — parent/gate side only."""
    import numpy as np

    from openr_tpu_torch.device import resolve_device
    from openr_tpu_torch.graph.linkstate import LinkState
    from openr_tpu_torch.ops.spf_sparse import (
        compile_ell,
        ell_source_batch,
        ell_view_batch_packed,
    )

    dev = resolve_device(device)
    out: Dict[str, List[int]] = {}
    for spec in specs:
        dbs = spec.build_dbs()
        ls = LinkState(area="0")
        for name in sorted(dbs):
            ls.update_adjacency_database(dbs[name])
        root = spec.root_of(dbs)
        digests = []
        for i in range(rounds):
            if i > 0:
                node = apply_mutation(dbs, spec, i)
                ls.update_adjacency_database(dbs[node])
            graph = compile_ell(ls)
            srcs = ell_source_batch(graph, ls, root)
            packed = np.asarray(
                ell_view_batch_packed(graph, srcs, dev).cpu()
            ).astype(np.int32)
            h = 0x811C9DC5
            for b in packed.tobytes():
                h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
            digests.append(h)
        out[spec.tenant_id] = digests
    return out


def oracle_fib_digests(
    specs: List[TenantSpec], rounds: int, every: int, device=None
) -> Dict[str, List[int]]:
    """Never-migrated FIB oracle: replay each tenant's schedule on a
    local ``SpfSolver`` through the SAME recipe the ctrl handler uses
    (``fleet_preload_views`` over the packed ELL view, then
    ``build_route_db`` -> canonical ``RouteDatabase``), digesting the
    wire form on the rounds ``run_client(fib_every=every)`` samples,
    on ``device`` (None = CUDA). Imports torch — parent/gate side only."""
    import numpy as np

    from openr_tpu_torch.decision.prefix_state import PrefixState
    from openr_tpu_torch.decision.spf_solver import (
        SpfSolver,
        fleet_preload_views,
    )
    from openr_tpu_torch.device import resolve_device
    from openr_tpu_torch.graph.linkstate import LinkState
    from openr_tpu_torch.ops.spf_sparse import (
        compile_ell,
        ell_source_batch,
        ell_view_batch_packed,
    )
    from openr_tpu_torch.utils import wire

    dev = resolve_device(device)
    out: Dict[str, List[int]] = {}
    for spec in specs:
        dbs = spec.build_dbs()
        ls = LinkState(area="0")
        for name in sorted(dbs):
            ls.update_adjacency_database(dbs[name])
        root = spec.root_of(dbs)
        pfx = PrefixState()
        for _name, pdb in sorted(spec.build_prefix_dbs().items()):
            pfx.update_prefix_database(pdb)
        solver = SpfSolver(root, backend="device", device=dev)
        digests: List[int] = []
        for i in range(rounds):
            if i > 0:
                node = apply_mutation(dbs, spec, i)
                ls.update_adjacency_database(dbs[node])
            if not every or (i + 1) % every != 0:
                continue
            graph = compile_ell(ls)
            srcs = ell_source_batch(graph, ls, root)
            packed = np.asarray(
                ell_view_batch_packed(graph, srcs, dev).cpu()
            ).astype(np.int32)
            fleet_preload_views(ls, [(graph, srcs, packed)])
            ddb = solver.build_route_db(root, {"0": ls}, pfx)
            blob = wire.dumps(ddb.to_route_db(root))
            h = 0x811C9DC5
            for b in blob:
                h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
            digests.append(h)
        out[spec.tenant_id] = digests
    return out


def harvest(procs) -> List[Dict]:
    """Join spawned clients and load their result files; a child that
    died without writing is reported as an error record."""
    import json as _json
    import os

    results = []
    for p, out_path in procs:
        p.join(timeout=300)
        if p.is_alive():
            p.terminate()
            results.append(
                {"client_id": out_path, "errors": ["timeout"]}
            )
            continue
        if not os.path.exists(out_path):
            results.append({
                "client_id": out_path,
                "errors": [f"no result file (exit {p.exitcode})"],
            })
            continue
        with open(out_path) as f:
            results.append(_json.load(f))
    return results


_KINDS = ("grid", "ring", "mesh")
_SLOS = ("premium", "standard", "bulk")


def fleet_specs(
    clients: int, tenants_per_client: int, size: int = 4
) -> Dict[str, List[TenantSpec]]:
    """Deterministic client->tenants layout for the fleet mode:
    topology kinds and SLO classes rotate so every class exercises
    placement."""
    out: Dict[str, List[TenantSpec]] = {}
    n = 0
    for c in range(clients):
        specs = []
        for t in range(tenants_per_client):
            specs.append(TenantSpec(
                tenant_id=f"c{c}_t{t}",
                kind=_KINDS[n % len(_KINDS)],
                size=size,
                seed=n + 1,
                slo=_SLOS[n % len(_SLOS)],
            ))
            n += 1
        out[f"c{c}"] = specs
    return out


def main(argv: List[str] = None) -> int:
    """``python -m openr_tpu_torch.load.multi_client --services N`` — bring
    up a ``FleetController`` fleet of N services (each with a hot
    standby unless ``--no-standby``), admit the tenant population by
    SLO class, drive it from spawned torch-free client processes, and
    gate every per-round view digest against the sequential oracle.
    Exit 0 only on full parity with zero client errors."""
    import argparse
    import os
    import tempfile

    ap = argparse.ArgumentParser(prog="multi_client")
    ap.add_argument("--services", type=int, default=2)
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--tenants-per-client", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--size", type=int, default=4)
    ap.add_argument("--no-standby", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default=None,
                    help="the services' device (default: cuda)")
    args = ap.parse_args(argv)

    from openr_tpu_torch.fleet import FleetController

    fc = FleetController(
        services=args.services,
        with_standby=not args.no_standby,
        device=args.device,
    )
    fc.start()
    report = {"ok": False, "services": args.services}
    try:
        ctrl_port = fc.serve_ctrl("127.0.0.1")
        client_specs = fleet_specs(
            args.clients, args.tenants_per_client, args.size
        )
        endpoints = {}
        for specs in client_specs.values():
            for s in specs:
                host, port = fc.admit(s.tenant_id, s.slo)
                endpoints[s.tenant_id] = [host, port]
        default_ep = next(iter(endpoints.values()))
        with tempfile.TemporaryDirectory() as td:
            procs = spawn_clients(
                default_ep[0], default_ep[1], client_specs,
                args.rounds, td,
                endpoints=endpoints,
                controller=["127.0.0.1", ctrl_port],
            )
            results = harvest(procs)
        all_specs = [
            s for specs in client_specs.values() for s in specs
        ]
        oracle = oracle_digests(all_specs, args.rounds, args.device)
        errors = [e for r in results for e in r.get("errors", [])]
        mismatches = []
        for r in results:
            for tid, digs in r.get("digests", {}).items():
                if digs != oracle.get(tid):
                    mismatches.append(tid)
        report.update({
            "ok": not errors and not mismatches,
            "tenants": len(endpoints),
            "errors": errors,
            "digest_mismatches": mismatches,
            "placement": fc.placement(),
            "counters": fc.counters(),
        })
    finally:
        fc.stop()
    text = json.dumps(report, indent=2, sort_keys=True, default=str)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
