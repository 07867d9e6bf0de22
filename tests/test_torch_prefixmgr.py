"""The port's PrefixManager (``prefixmgr/prefix_manager.py``) and
allocators (``allocators/{range,prefix}_allocator.py``) against
``openr_tpu``'s, on the same inputs.

PrefixManager: the same advertisements, withdrawals, syncs and Decision
route updates must make the same KvStore client calls, in order, with the
same keys, payloads (wire bytes) and TTLs. Allocators: a lone node must
elect the reference's value (both packages seed their generator with the
node name), nodes sharing a KvStore mesh must elect distinct ones, and
``sub_prefix``/``parse_alloc_params`` must carve the same prefixes. Every
wait polls against a deadline; every store and event base is stopped.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from openr_tpu.allocators import prefix_allocator as jax_pa
from openr_tpu.allocators import range_allocator as jax_ra
from openr_tpu.decision import rib as jax_rib
from openr_tpu.kvstore import client as jax_client
from openr_tpu.kvstore import wrapper as jax_wrapper
from openr_tpu.messaging import queue as jax_queue
from openr_tpu.prefixmgr import prefix_manager as jax_pm
from openr_tpu import types as jax_types
from openr_tpu.types import lsdb as jax_lsdb
from openr_tpu.utils import eventbase as jax_evb
from openr_tpu_torch.allocators import prefix_allocator as port_pa
from openr_tpu_torch.allocators import range_allocator as port_ra
from openr_tpu_torch.decision import rib as port_rib
from openr_tpu_torch.kvstore import client as port_client
from openr_tpu_torch.kvstore import wrapper as port_wrapper
from openr_tpu_torch.messaging import queue as port_queue
from openr_tpu_torch.prefixmgr import prefix_manager as port_pm
from openr_tpu_torch import types as port_types
from openr_tpu_torch.types import lsdb as port_lsdb
from openr_tpu_torch.utils import eventbase as port_evb

PKGS = {
    "port": SimpleNamespace(pa=port_pa, ra=port_ra, rib=port_rib, client=port_client,
                            wrapper=port_wrapper, queue=port_queue, pm=port_pm, T=port_types,
                            lsdb=port_lsdb, evb=port_evb),
    "jax": SimpleNamespace(pa=jax_pa, ra=jax_ra, rib=jax_rib, client=jax_client,
                           wrapper=jax_wrapper, queue=jax_queue, pm=jax_pm, T=jax_types,
                           lsdb=jax_lsdb, evb=jax_evb),
}
WAIT_S = 15.0


def wait_until(pred, timeout=WAIT_S, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


# -- PrefixManager -------------------------------------------------------------


class RecordingClient:
    """The KvStore client calls PrefixManager makes, in order."""

    def __init__(self):
        self.calls = []

    def persist_key(self, area, key, value):
        self.calls.append(("persist", area, key, bytes(value)))

    def set_key(self, area, key, value, *args, **kwargs):
        self.calls.append(("set", area, key, bytes(value)))

    def unset_key(self, area, key):
        self.calls.append(("unset", area, key))

    def clear_key(self, area, key, value, ttl=None):
        self.calls.append(("clear", area, key, bytes(value), ttl))


def _entry(p, prefix, ptype="LOOPBACK", **kw):
    return p.T.PrefixEntry(prefix=p.T.IpPrefix.from_str(prefix),
                           type=getattr(p.T.PrefixType, ptype), **kw)


def _advertise(p, pm, q):
    pm.advertise_prefixes([_entry(p, "fd00:1::1/128"), _entry(p, "10.0.0.1/32")])


def _two_types(p, pm, q):
    pm.advertise_prefixes([_entry(p, "fd00:2::/64", "BGP")])
    pm.advertise_prefixes([_entry(p, "fd00:2::/64", "LOOPBACK",
                                  metrics=p.lsdb.PrefixMetrics(path_preference=2000))])
    pm.advertise_prefixes([_entry(p, "fd00:3::/64", "DEFAULT")])


def _withdraw(p, pm, q):
    _advertise(p, pm, q)
    pm.withdraw_prefixes([p.T.IpPrefix.from_str("fd00:1::1/128")])


def _sync_by_type(p, pm, q):
    pm.advertise_prefixes([_entry(p, "fd00:4::/64", "BGP"), _entry(p, "fd00:5::/64", "BGP"),
                           _entry(p, "fd00:6::/64", "LOOPBACK")])
    pm.sync_prefixes_by_type(p.T.PrefixType.BGP, [_entry(p, "fd00:5::/64", "BGP"),
                                                   _entry(p, "fd00:7::/64", "BGP")])


def _queue_events(p, pm, q):
    ev, kind = p.pm.PrefixEvent, p.pm.PrefixEventType
    q.push(ev(kind.ADD_PREFIXES, prefixes=[_entry(p, "fd00:8::/64", "BGP"),
                                           _entry(p, "fd00:9::/64", "BGP")]))
    q.push(ev(kind.WITHDRAW_PREFIXES, prefixes=[_entry(p, "fd00:8::/64", "BGP")]))
    q.push(ev(kind.SYNC_PREFIXES_BY_TYPE, type=p.T.PrefixType.LOOPBACK,
              prefixes=[_entry(p, "fd00:a::/64")]))
    q.push(ev(kind.WITHDRAW_PREFIXES_BY_TYPE, type=p.T.PrefixType.BGP))
    # the reader delivers in order: the last event's keys are the tail
    assert wait_until(lambda: len(pm.get_prefixes()) == 1 and
                      pm.get_prefixes()[0].prefix == p.T.IpPrefix.from_str("fd00:a::/64"))
    time.sleep(0.1)


def _route_update(p, prefix, best_area, area_stack=()):
    update = p.rib.DecisionRouteUpdate()
    prefix = p.T.IpPrefix.from_str(prefix)
    update.unicast_routes_to_update[prefix] = p.rib.RibUnicastEntry(
        prefix=prefix, best_prefix_entry=p.T.PrefixEntry(
            prefix=prefix, metrics=p.lsdb.PrefixMetrics(path_preference=700),
            area_stack=area_stack),
        best_area=best_area)
    return update


def _redistribution(p, pm, q):
    pm.advertise_prefixes([_entry(p, "fd00:c::1/128")])
    q.push(_route_update(p, "fd00:a::1/128", "1"))
    q.push(_route_update(p, "fd00:b::1/128", "1", area_stack=("2",)))
    q.push(_route_update(p, "fd00:c::1/128", "2"))
    assert wait_until(lambda: len(pm.get_redistributed()) == 1)
    time.sleep(0.2)
    update = p.rib.DecisionRouteUpdate()
    update.unicast_routes_to_delete.append(p.T.IpPrefix.from_str("fd00:a::1/128"))
    q.push(update)
    assert wait_until(lambda: not pm.get_redistributed())


PM_SCENARIOS = {
    "advertise": (_advertise, {}),
    "advertise_full_db": (_advertise, {"per_prefix_keys": False}),
    "two_types": (_two_types, {}),
    "two_types_full_db": (_two_types, {"per_prefix_keys": False}),
    "withdraw": (_withdraw, {}),
    "withdraw_full_db": (_withdraw, {"per_prefix_keys": False}),
    "sync_by_type": (_sync_by_type, {}),
    "queue_events": (_queue_events, {"areas": ["0", "1"]}),
    "redistribution": (_redistribution, {"areas": ["1", "2"]}),
    "redistribution_full_db": (_redistribution, {"areas": ["1", "2"], "per_prefix_keys": False}),
}


def _run_pm(pkg, scenario):
    p = PKGS[pkg]
    script, kwargs = PM_SCENARIOS[scenario]
    client = RecordingClient()
    prefix_q = p.queue.ReplicateQueue(name="prefixUpdates")
    route_q = p.queue.ReplicateQueue(name="routeUpdates")
    routes = route_q if scenario.startswith("redistribution") else None
    pm = p.pm.PrefixManager("pm-node", client, prefix_updates_queue=prefix_q,
                            decision_route_updates_queue=routes, **kwargs)
    pm.start()
    try:
        script(p, pm, route_q if routes is not None else prefix_q)
        prefixes = [str(e.prefix) for e in pm.get_prefixes()]
        redist = sorted((str(k), v[1]) for k, v in pm.get_redistributed().items())
        return client.calls, prefixes, redist
    finally:
        pm.stop()
        prefix_q.close()
        route_q.close()


@pytest.mark.parametrize("scenario", sorted(PM_SCENARIOS))
def test_prefix_manager_makes_the_reference_kvstore_calls(scenario):
    port, ref = _run_pm("port", scenario), _run_pm("jax", scenario)
    assert port[0] and port[0] == ref[0]
    assert port[1:] == ref[1:]


# -- allocators ----------------------------------------------------------------


class Mesh:
    """A full mesh of KvStores with a client and an event base per node
    (``tests/test_allocators_policy.py``'s ``AllocatorNet``)."""

    def __init__(self, p, names):
        self.p = p
        self.stores, self.evbs, self.clients = {}, {}, {}
        for name in names:
            w = p.wrapper.KvStoreWrapper(name)
            w.start()
            self.stores[name] = w
            evb = p.evb.OpenrEventBase(f"alloc:{name}")
            evb.run_in_thread()
            self.evbs[name] = evb
            self.clients[name] = p.client.KvStoreClient(evb, name, w.store)
        names = list(names)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                p.wrapper.link_bidirectional(self.stores[a], self.stores[b])

    def stop(self):
        for evb in self.evbs.values():
            evb.stop()
            evb.join()
        for w in self.stores.values():
            w.stop()


def _range_values(pkg, names, rng, init_value=None):
    p = PKGS[pkg]
    mesh = Mesh(p, names)
    values, allocators = {}, []
    try:
        for name in names:
            a = p.ra.RangeAllocator(mesh.evbs[name], mesh.clients[name], name, "alloc-test:",
                                    rng, lambda v, name=name: values.__setitem__(name, v))
            a.start_allocator(init_value=init_value)
            allocators.append(a)
        assert wait_until(lambda: len(values) == len(names)
                          and None not in values.values()), values
        return dict(values)
    finally:
        for a in allocators:
            a.stop()
        mesh.stop()


@pytest.mark.parametrize("name", ("node-a", "rsw-0-0", "d-fsw-1-3"))
@pytest.mark.parametrize("rng", ((0, 15), (100, 1123)))
def test_a_lone_range_allocator_elects_the_reference_value(name, rng):
    assert _range_values("port", [name], rng) == _range_values("jax", [name], rng)


def test_range_allocators_elect_distinct_values_and_keep_a_contested_one():
    names = [f"node-{i}" for i in range(4)]
    values = _range_values("port", names, (0, 15))
    assert len(set(values.values())) == 4
    contested = _range_values("port", ["node-a", "node-b"], (0, 7), init_value=3)
    assert len(set(contested.values())) == 2 and 3 in contested.values()


@pytest.mark.parametrize("seed,alloc_len", (("fd00::/48", 64), ("fd00:5707::/61", 64),
                                            ("10.0.0.0/16", 24)))
def test_prefix_carving_matches_the_reference(seed, alloc_len):
    port_seed, jax_seed = port_types.IpPrefix.from_str(seed), jax_types.IpPrefix.from_str(seed)
    for index in (0, 1, 5, 7, 2 ** (alloc_len - port_seed.prefix_length) - 1):
        assert str(port_pa.sub_prefix(port_seed, alloc_len, index)) == \
            str(jax_pa.sub_prefix(jax_seed, alloc_len, index))
    text = f"{seed},{alloc_len}"
    port_p, jax_p = port_pa.parse_alloc_params(text), jax_pa.parse_alloc_params(text)
    assert (str(port_p[0]), port_p[1]) == (str(jax_p[0]), jax_p[1])


class RecordingPrefixManager:
    def __init__(self):
        self.advertised = []

    def advertise_prefixes(self, entries):
        self.advertised.extend(str(e.prefix) for e in entries)

    def withdraw_prefixes(self, prefixes):
        for prefix in prefixes:
            if str(prefix) in self.advertised:
                self.advertised.remove(str(prefix))


def _prefix_allocations(pkg, names, seed, alloc_len=64):
    p = PKGS[pkg]
    mesh = Mesh(p, names)
    allocs, managers = [], {n: RecordingPrefixManager() for n in names}
    try:
        for name in names:
            allocs.append(p.pa.PrefixAllocator(
                name, mesh.evbs[name], mesh.clients[name], managers[name],
                seed_prefix=p.T.IpPrefix.from_str(seed), alloc_prefix_len=alloc_len))
        assert wait_until(lambda: all(a.allocated_prefix is not None for a in allocs))
        return ({n: str(a.allocated_prefix) for n, a in zip(names, allocs)},
                {n: m.advertised for n, m in managers.items()})
    finally:
        for a in allocs:
            a.stop()
        mesh.stop()


@pytest.mark.parametrize("name", ("node-x", "d-rsw-1-2"))
def test_a_lone_prefix_allocator_elects_the_reference_prefix(name):
    port = _prefix_allocations("port", [name], "fd00:cafe::/56")
    assert port == _prefix_allocations("jax", [name], "fd00:cafe::/56")
    assert port[1][name] == [port[0][name]]


def test_prefix_allocators_elect_distinct_prefixes():
    names = ["node-a", "node-b", "node-c"]
    allocated, advertised = _prefix_allocations("port", names, "fd00::/60")
    assert len(set(allocated.values())) == 3
    assert all(advertised[n] == [allocated[n]] for n in names)


def test_static_prefix_allocation_matches_the_reference():
    out = {}
    for pkg in ("port", "jax"):
        p = PKGS[pkg]
        evb = p.evb.OpenrEventBase("static-alloc")
        evb.run_in_thread()
        mgr = RecordingPrefixManager()
        try:
            target = p.T.IpPrefix.from_str("fd00:9::/64")
            alloc = p.pa.PrefixAllocator("node-x", evb, None, mgr,
                                         static_prefixes={"node-x": target})
            assert wait_until(lambda: alloc.allocated_prefix == target)
            out[pkg] = (str(alloc.allocated_prefix), mgr.advertised)
        finally:
            evb.stop()
            evb.join()
    assert out["port"] == out["jax"]
