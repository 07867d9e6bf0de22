"""The port's Fib and FIB service against ``openr_tpu``'s, fed the same
route updates.

One seeded sequence of ``DecisionRouteUpdate``s (unicast adds and
deletes, MPLS adds and deletes, some routes marked do-not-install) goes
into each package's ``Fib`` over its own ``MockFibAgent``. Prefixes and
next hops are made in the port's types and cross to the reference's as
wire bytes. After every update the programmed unicast and MPLS tables,
Fib's desired state, its ``fib_updates`` publications and both counter
sets must be the same, byte for byte, through an agent failure and the
retry, an agent restart and the resync, do-not-install, dry run and a
graceful restart. The synchronous cases call the handlers the event base
would call (``_on_route_update``, the retry timer's ``_retry``, the
keepalive's ``_check_agent``); one case runs both modules' event bases
and waits on conditions with deadlines.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest

from openr_tpu.decision import rib as jax_rib
from openr_tpu.fib import fib as jax_fib
from openr_tpu.messaging import queue as jax_queue
from openr_tpu.platform import fib_service as jax_service
from openr_tpu.types import IpPrefix as JaxIpPrefix
from openr_tpu.types import NextHop as JaxNextHop
from openr_tpu.types import RouteDatabase as JaxRouteDatabase
from openr_tpu.utils import wire as jax_wire
from openr_tpu_torch.decision import rib as port_rib
from openr_tpu_torch.fib import fib as port_fib
from openr_tpu_torch.messaging import queue as port_queue
from openr_tpu_torch.platform import fib_service as port_service
from openr_tpu_torch.types import (
    BinaryAddress,
    IpPrefix,
    MplsAction,
    MplsActionCode,
    NextHop,
    RouteDatabase,
)
from openr_tpu_torch.utils import wire

PACKAGES = {
    "port": SimpleNamespace(rib=port_rib, fib=port_fib, queue=port_queue,
                            service=port_service, wire=wire, IpPrefix=IpPrefix,
                            NextHop=NextHop, RouteDatabase=RouteDatabase),
    "jax": SimpleNamespace(rib=jax_rib, fib=jax_fib, queue=jax_queue,
                           service=jax_service, wire=jax_wire, IpPrefix=JaxIpPrefix,
                           NextHop=JaxNextHop, RouteDatabase=JaxRouteDatabase),
}
NODE = "node-a"
STEPS = 30
WAIT_S = 20.0

PREFIXES = [IpPrefix.from_str(f"fd00:{i:x}::/64") for i in range(1, 13)] + [
    IpPrefix.from_str(f"10.{i}.0.0/16") for i in range(3)] + [IpPrefix.from_str("fd00::/16")]
NEXTHOPS = [
    NextHop(address=BinaryAddress.from_str(f"fe80::{i}", if_name=f"if{i % 3}"), metric=1 + i % 4)
    for i in range(1, 7)
] + [
    NextHop(address=BinaryAddress.from_str("fe80::9", if_name="if9"), metric=2,
            mpls_action=MplsAction(MplsActionCode.PUSH, push_labels=(100001, 100002))),
]
LABELS = list(range(100100, 100108))
LABEL_NEXTHOPS = [
    NextHop(address=BinaryAddress.from_str(f"fe80::{i}", if_name=f"if{i}"), metric=1,
            mpls_action=MplsAction(MplsActionCode.SWAP, swap_label=200000 + i))
    for i in range(1, 4)
] + [NextHop(address=BinaryAddress.from_str("fe80::5", if_name="if5"), metric=1,
             mpls_action=MplsAction(MplsActionCode.PHP))]


def wait_until(pred, timeout=WAIT_S, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return bool(pred())


def cross(pkg, obj, cls):
    """``obj`` (a port type) in ``pkg``'s types, through the wire."""
    return obj if pkg is PACKAGES["port"] else jax_wire.loads(wire.dumps(obj), cls)


def plan_updates(seed, do_not_install_share):
    """A seeded sequence of updates as plain specs: unicast (prefix index,
    next hop indices, do-not-install), deletes, MPLS (label, next hop
    indices) and MPLS deletes."""
    rng = np.random.default_rng(seed)
    live, live_labels = set(), set()
    plan = []
    for _ in range(STEPS):
        adds = []
        for i in rng.choice(len(PREFIXES), int(rng.integers(0, 5)), replace=False):
            nhs = sorted(rng.choice(len(NEXTHOPS), int(rng.integers(1, 4)), replace=False))
            adds.append((int(i), [int(n) for n in nhs], bool(rng.random() < do_not_install_share)))
        deletes = [p for p in sorted(live) if rng.random() < 0.15 and p not in {a[0] for a in adds}]
        mpls = []
        for label in rng.choice(LABELS, int(rng.integers(0, 3)), replace=False):
            nhs = sorted(rng.choice(len(LABEL_NEXTHOPS), int(rng.integers(1, 3)), replace=False))
            mpls.append((int(label), [int(n) for n in nhs]))
        mpls_deletes = [x for x in sorted(live_labels)
                        if rng.random() < 0.2 and x not in {m[0] for m in mpls}]
        live |= {a[0] for a in adds}
        live -= set(deletes)
        live_labels |= {m[0] for m in mpls}
        live_labels -= set(mpls_deletes)
        plan.append((adds, deletes, mpls, mpls_deletes))
    return plan


def build_update(pkg, spec):
    adds, deletes, mpls, mpls_deletes = spec
    update = pkg.rib.DecisionRouteUpdate()
    for i, nhs, dni in adds:
        prefix = cross(pkg, PREFIXES[i], pkg.IpPrefix)
        update.unicast_routes_to_update[prefix] = pkg.rib.RibUnicastEntry(
            prefix=prefix, nexthops={cross(pkg, NEXTHOPS[n], pkg.NextHop) for n in nhs},
            do_not_install=dni)
    update.unicast_routes_to_delete.extend(cross(pkg, PREFIXES[i], pkg.IpPrefix) for i in deletes)
    update.mpls_routes_to_update.extend(
        pkg.rib.RibMplsEntry(label, {cross(pkg, LABEL_NEXTHOPS[n], pkg.NextHop) for n in nhs})
        for label, nhs in mpls)
    update.mpls_routes_to_delete.extend(mpls_deletes)
    return update


class FibRun:
    """One package's Fib over a MockFibAgent, with a reader on its
    ``fib_updates`` queue. ``snapshot`` is everything the comparison
    reads, as wire bytes and plain dicts."""

    def __init__(self, pkg, **kwargs):
        self.pkg = pkg
        self.agent = pkg.service.MockFibAgent()
        self.route_q = pkg.queue.ReplicateQueue(name="routeUpdates")
        self.fib_updates = pkg.queue.ReplicateQueue(name="fibUpdates")
        self.reader = self.fib_updates.get_reader("test")
        kwargs.setdefault("keepalive_interval_s", 3600.0)
        self.fib = pkg.fib.Fib(NODE, self.agent, self.route_q,
                               fib_updates_queue=self.fib_updates, **kwargs)

    def programmed(self):
        client = self.pkg.fib.OPENR_CLIENT_ID
        return self.pkg.wire.dumps(self.pkg.RouteDatabase(
            this_node_name=NODE,
            unicast_routes=self.agent.get_route_table_by_client(client),
            mpls_routes=self.agent.get_mpls_route_table_by_client(client)))

    def published(self):
        out = []
        while self.reader.size():
            out.append(self.pkg.wire.dumps(self.reader.get().to_route_db_delta(NODE)))
        return out

    def snapshot(self):
        desired = self.pkg.RouteDatabase(
            this_node_name=NODE, unicast_routes=list(self.fib.unicast_routes.values()),
            mpls_routes=list(self.fib.mpls_routes.values())).canonicalize()
        return {
            "programmed": self.programmed(),
            "desired": self.pkg.wire.dumps(desired),
            "published": self.published(),
            "fib_counters": dict(self.fib.counters),
            "agent_counters": dict(self.agent.counters),
            "dirty": self.fib._dirty,
            "synced_once": self.fib._synced_once,
        }

    def stop(self):
        self.route_q.close()
        self.fib.stop()


def _drive(pkg, scenario, plan):
    """Feed ``plan`` to one package's Fib as ``scenario`` says; the
    snapshot after every step."""
    kwargs = {"dry_run": True} if scenario == "dry_run" else {}
    run = FibRun(pkg, **kwargs)
    snaps = []
    try:
        if scenario == "graceful_restart":
            # a warm boot: the previous life's routes are held until the
            # first update, which ends the hold with one full sync
            # (unicast only: the reference raises on a held MPLS route,
            # see test_graceful_restart_holds_mpls_routes)
            held = build_update(pkg, plan[0])
            run.fib.start_graceful_restart(pkg.RouteDatabase(
                this_node_name=NODE,
                unicast_routes=[e.to_unicast_route()
                                for e in held.unicast_routes_to_update.values()]))
            snaps.append(run.snapshot())
        if scenario == "agent_restart":
            run.fib._check_agent()  # the first keepalive takes the baseline
        for step, spec in enumerate(plan):
            if scenario == "agent_failure_retry" and step == 8:
                run.agent.set_fail(True)
            if scenario == "agent_failure_retry" and step == 12:
                run.agent.set_fail(False)
                run.fib._retry()  # the backoff timer firing
            if scenario == "agent_restart" and step == 10:
                run.agent.restart()
                run.fib._check_agent()  # the keepalive noticing
            run.fib._on_route_update(build_update(pkg, spec))
            snaps.append(run.snapshot())
    finally:
        run.stop()
    return snaps


SCENARIOS = {
    "plain": 0.0,
    "agent_failure_retry": 0.0,
    "agent_restart": 0.0,
    "do_not_install": 0.3,
    "dry_run": 0.2,
    "graceful_restart": 0.1,
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_fib_matches_reference(scenario, seed):
    plan = plan_updates(seed * 100 + len(scenario), SCENARIOS[scenario])
    got = _drive(PACKAGES["port"], scenario, plan)
    want = _drive(PACKAGES["jax"], scenario, plan)
    assert len(got) == len(want)
    for step, (g, w) in enumerate(zip(got, want)):
        assert g == w, (scenario, step)
    last = got[-1]
    if scenario == "dry_run":
        assert last["programmed"] == wire.dumps(RouteDatabase(this_node_name=NODE))
        assert last["agent_counters"]["sync_fib"] == 0
    else:
        assert last["programmed"] != wire.dumps(RouteDatabase(this_node_name=NODE))
    if scenario == "agent_failure_retry":
        assert last["fib_counters"]["fib.route_programming_failures"] > 0
        assert last["fib_counters"]["fib.unacked_reprogrammed"] > 0
    if scenario == "agent_restart":
        assert last["fib_counters"]["fib.agent_restarts"] == 1
    if scenario == "graceful_restart":
        assert last["fib_counters"]["fib.gr_reconciles"] == 1
    if scenario == "do_not_install":
        desired = wire.loads(last["desired"], RouteDatabase)
        programmed = wire.loads(last["programmed"], RouteDatabase)
        assert any(r.do_not_install for r in desired.unicast_routes)
        assert not any(r.do_not_install for r in programmed.unicast_routes)


def test_fib_event_base_matches_reference():
    """Both modules started on their event bases: the same updates
    through the route queue, an agent failure and the backoff retry, an
    agent restart caught by the keepalive; the programmed tables, the
    longest-prefix matches and the unicast route lists agree."""
    plan = plan_updates(7, 0.2)
    out = {}
    for name, pkg in PACKAGES.items():
        run = FibRun(pkg, keepalive_interval_s=0.05, retry_min_s=0.02, retry_max_s=0.2)
        run.fib.start()
        try:
            for spec in plan[:10]:
                run.route_q.push(build_update(pkg, spec))
            assert wait_until(lambda: run.fib.get_counters()["fib.routes_programmed"] > 0), name
            run.agent.set_fail(True)
            for spec in plan[10:15]:
                run.route_q.push(build_update(pkg, spec))
            assert wait_until(lambda: run.fib.get_counters()[
                "fib.route_programming_failures"] >= 1), name
            run.agent.set_fail(False)
            for spec in plan[15:]:
                run.route_q.push(build_update(pkg, spec))

            def settled():
                want = run.fib.get_route_db()
                client = pkg.fib.OPENR_CLIENT_ID
                return (not run.fib._dirty and [r for r in want.unicast_routes
                                                if not r.do_not_install]
                        == run.agent.get_route_table_by_client(client)
                        and want.mpls_routes == run.agent.get_mpls_route_table_by_client(client))

            assert wait_until(settled), name
            run.agent.restart()
            assert wait_until(lambda: run.fib.get_counters()["fib.agent_restarts"] == 1), name
            assert wait_until(settled), name
            lpm = [run.fib.longest_prefix_match(a)
                   for a in ("fd00:3::1", "fd00:9::5", "fd00:ff::1", "10.1.2.3", "192.0.2.1")]
            out[name] = (
                run.programmed(),
                pkg.wire.dumps(run.fib.get_route_db()),
                [pkg.wire.dumps(r) if r is not None else None for r in lpm],
                [pkg.wire.dumps(r) for r in run.fib.get_unicast_routes()],
            )
        finally:
            run.stop()
    assert out["port"] == out["jax"]


def test_graceful_restart_holds_mpls_routes():
    """A warm boot holding unicast and MPLS routes: nothing is programmed
    during the hold, and the first update ends it with one full sync of
    the desired state. The reference raises here (it keys the held MPLS
    route by ``label``, a field ``MplsRoute`` does not have); the port
    keys it by ``top_label``."""
    plan = plan_updates(11, 0.0)
    first = next(i for i, (adds, _, mpls, _) in enumerate(plan) if adds and mpls)
    held = build_update(PACKAGES["port"], plan[first])
    route_db = RouteDatabase(
        this_node_name=NODE,
        unicast_routes=[e.to_unicast_route() for e in held.unicast_routes_to_update.values()],
        mpls_routes=[e.to_mpls_route() for e in held.mpls_routes_to_update])
    assert route_db.mpls_routes
    with pytest.raises(AttributeError):
        jax_fib.Fib(NODE, jax_service.MockFibAgent(), jax_queue.ReplicateQueue()) \
            .start_graceful_restart(jax_wire.loads(wire.dumps(route_db), JaxRouteDatabase))
    run = FibRun(PACKAGES["port"])
    try:
        run.fib.start_graceful_restart(route_db)
        assert set(run.fib.mpls_routes) == {r.top_label for r in route_db.mpls_routes}
        assert run.agent.counters["sync_fib"] == 0
        run.fib._on_route_update(build_update(PACKAGES["port"], plan[first + 1]))
        snap = run.snapshot()
        assert snap["fib_counters"]["fib.gr_reconciles"] == 1
        assert run.agent.counters["sync_mpls_fib"] == 1
        assert snap["programmed"] == wire.dumps(RouteDatabase(
            this_node_name=NODE,
            unicast_routes=[r for r in wire.loads(snap["desired"], RouteDatabase).unicast_routes],
            mpls_routes=wire.loads(snap["desired"], RouteDatabase).mpls_routes))
    finally:
        run.stop()
