"""The port's KvStore, its client and its DUAL flood optimisation against
``openr_tpu``'s, fed the same inputs.

Inputs come from a seed (numpy) and cross between the packages as wire
bytes: a ``Value`` made in the port's types is encoded with the port's
``utils.wire`` and decoded into the reference's. The bar is bit-identity:
the merge rules must return the same results and accept the same sets,
and after a flood, a three-way sync or a TTL countdown every store must
hold the same values, byte for byte, in both packages. Stores run their
event base threads: every wait polls a condition against a deadline, and
every store, client and event base is stopped before its test ends.
"""

from __future__ import annotations

import time
from collections import deque
from types import SimpleNamespace
from typing import Dict

import numpy as np
import pytest

from openr_tpu.dual import dual as jax_dual
from openr_tpu.faults import FaultSchedule as JaxFaultSchedule
from openr_tpu.faults import get_injector as jax_injector
from openr_tpu.kvstore import client as jax_client
from openr_tpu.kvstore import store as jax_store
from openr_tpu.kvstore import wrapper as jax_wrapper
from openr_tpu.types import TTL_INFINITY as JAX_TTL_INFINITY
from openr_tpu.types import KeyDumpParams as JaxKeyDumpParams
from openr_tpu.types import KeySetParams as JaxKeySetParams
from openr_tpu.types import KvStorePeerState as JaxPeerState
from openr_tpu.types import Value as JaxValue
from openr_tpu.utils import eventbase as jax_eventbase
from openr_tpu.utils import wire as jax_wire
from openr_tpu_torch.dual import dual as port_dual
from openr_tpu_torch.faults import FaultSchedule, get_injector
from openr_tpu_torch.kvstore import client as port_client
from openr_tpu_torch.kvstore import store as port_store
from openr_tpu_torch.kvstore import wrapper as port_wrapper
from openr_tpu_torch.types import (
    TTL_INFINITY,
    KeyDumpParams,
    KeySetParams,
    KvStorePeerState,
    Value,
)
from openr_tpu_torch.utils import eventbase as port_eventbase
from openr_tpu_torch.utils import wire

assert TTL_INFINITY == JAX_TTL_INFINITY

PACKAGES = {
    "port": SimpleNamespace(
        store=port_store, wrapper=port_wrapper, client=port_client, dual=port_dual,
        evb=port_eventbase, wire=wire, Value=Value, KeySetParams=KeySetParams,
        KeyDumpParams=KeyDumpParams, INITIALIZED=KvStorePeerState.INITIALIZED,
        injector=get_injector, FaultSchedule=FaultSchedule,
    ),
    "jax": SimpleNamespace(
        store=jax_store, wrapper=jax_wrapper, client=jax_client, dual=jax_dual,
        evb=jax_eventbase, wire=jax_wire, Value=JaxValue, KeySetParams=JaxKeySetParams,
        KeyDumpParams=JaxKeyDumpParams, INITIALIZED=JaxPeerState.INITIALIZED,
        injector=jax_injector, FaultSchedule=JaxFaultSchedule,
    ),
}

ORIGINATORS = ("node-a", "node-b", "node-c")
PAYLOADS = (b"", b"a", b"aa", b"b", b"v1", b"v2")
TTLS = (TTL_INFINITY, TTL_INFINITY, 0, -5, 150, 5000)
KEYS = ("adj:n1", "adj:n2", "prefix:n1", "prefix:n2", "fibtime:n1")
WAIT_S = 20.0


def wait_until(pred, timeout=WAIT_S, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return bool(pred())


def to_jax(value: Value) -> JaxValue:
    """The same Value in the reference's types, through the wire."""
    return jax_wire.loads(wire.dumps(value), JaxValue)


def rand_value(rng) -> Value:
    version = int(rng.integers(1, 4))
    originator = ORIGINATORS[int(rng.integers(len(ORIGINATORS)))]
    payload = None if rng.random() < 0.2 else PAYLOADS[int(rng.integers(len(PAYLOADS)))]
    return Value(
        version=version,
        originator_id=originator,
        value=payload,
        ttl=TTLS[int(rng.integers(len(TTLS)))],
        ttl_version=int(rng.integers(0, 3)),
        hash=None if rng.random() < 0.2 else wire.generate_hash(version, originator, payload),
    )


def rand_filters(rng):
    """Filter arguments (or None), as plain lists and sets."""
    pick = int(rng.integers(4))
    if pick == 0:
        return None
    prefixes = ["adj:"] if pick in (1, 3) else []
    originators = {"node-b"} if pick in (2, 3) else set()
    return prefixes, originators


# -- merge rules -------------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_compare_values_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(300):
        a, b = rand_value(rng), rand_value(rng)
        if rng.random() < 0.2:  # an equal pair, or one that differs in ttl_version
            b = Value(a.version, a.originator_id, a.value, a.ttl,
                      int(rng.integers(0, 3)), a.hash)
        want = jax_store.compare_values(to_jax(a), to_jax(b))
        assert port_store.compare_values(a, b) == want, (a, b)


@pytest.mark.parametrize("seed", range(8))
def test_merge_key_values_matches_reference(seed):
    """A seeded sequence of batches merged into one store in each package:
    each batch's accepted updates and the store after it are the same
    wire bytes."""
    rng = np.random.default_rng(1000 + seed)
    port_kv, jax_kv = {}, {}
    accepted = 0
    for _ in range(60):
        batch = {KEYS[int(i)]: rand_value(rng)
                 for i in rng.integers(0, len(KEYS), int(rng.integers(1, 4)))}
        spec = rand_filters(rng)
        port_f = port_store.KvStoreFilters(*spec) if spec else None
        jax_f = jax_store.KvStoreFilters(*spec) if spec else None
        got = port_store.merge_key_values(port_kv, batch, port_f)
        want = jax_store.merge_key_values(
            jax_kv, {k: to_jax(v) for k, v in batch.items()}, jax_f)
        assert sorted(got) == sorted(want)
        assert wire.dumps(got) == jax_wire.dumps(want)
        assert wire.dumps(port_kv) == jax_wire.dumps(jax_kv)
        accepted += len(got)
    # the sequence exercised both outcomes
    assert 0 < accepted < 60 * 3


# -- flooding, sync and TTLs over in-process stores --------------------------


class Net:
    """In-process stores of one package; ``stored`` is every store's
    values as held (not the dump's remaining-TTL rewrite), as wire bytes."""

    def __init__(self, pkg, **store_kwargs):
        self.pkg = pkg
        self.store_kwargs = store_kwargs
        self.stores = {}

    def add(self, name, **kwargs):
        s = self.pkg.wrapper.KvStoreWrapper(name, **{**self.store_kwargs, **kwargs})
        s.start()
        self.stores[name] = s
        return s

    def link(self, a, b):
        self.pkg.wrapper.link_bidirectional(self.stores[a], self.stores[b])

    def set(self, name, key, value, **kwargs):
        self.stores[name].set_key(key, value, **kwargs)

    def initialized(self):
        return all(
            all(st == self.pkg.INITIALIZED for st in s.peer_states().values())
            for s in self.stores.values()
        )

    def keys(self, name):
        return set(self.stores[name].dump())

    def stored(self):
        out = {}
        for name, s in sorted(self.stores.items()):
            keys = sorted(s.store.dump_with_filters("0").key_vals)
            out[name] = self.pkg.wire.dumps(s.store.get_key_vals("0", keys))
        return out

    def stop(self):
        for s in self.stores.values():
            s.stop()


def _star(net):
    net.add("hub")
    for i in range(4):
        net.add(f"leaf-{i}")
        net.link("hub", f"leaf-{i}")
    assert wait_until(net.initialized)
    for i in range(4):
        net.set(f"leaf-{i}", f"adj:leaf-{i}", b"x%d" % i)
    net.set("leaf-0", "prefix:leaf-0", b"p0", version=3)
    want = {f"adj:leaf-{i}" for i in range(4)} | {"prefix:leaf-0"}
    return lambda: all(net.keys(n) == want for n in net.stores)


def _ring(net):
    for i in range(5):
        net.add(f"r{i}")
    for i in range(5):
        net.link(f"r{i}", f"r{(i + 1) % 5}")
    assert wait_until(net.initialized)
    net.set("r2", "rk", b"ring")
    # a conflict: the same key and version from two originators
    net.set("r0", "adj:c", b"alpha", version=2, originator="node-a")
    net.set("r3", "adj:c", b"beta", version=2, originator="node-b")
    return lambda: all(
        net.keys(n) == {"rk", "adj:c"}
        and net.stores[n].get_key("adj:c").originator_id == "node-b"
        for n in net.stores
    )


def _three_way_sync(net):
    a, b = net.add("node-a"), net.add("node-b")
    a.set_key("only-a", b"a")
    b.set_key("only-b", b"b")
    # the same key on both sides: the higher value wins the tie
    a.set_key("both", b"aaa", version=4)
    b.set_key("both", b"bbb", version=4, originator="node-a")
    net.link("node-a", "node-b")
    return lambda: all(net.keys(n) == {"only-a", "only-b", "both"}
                       and net.stores[n].get_key("both").value == b"bbb"
                       for n in net.stores)


def _ttl_decrement_on_flood(net):
    for name in ("a", "b", "c"):
        net.add(name)
    net.link("a", "b")
    net.link("b", "c")
    assert wait_until(net.initialized)
    net.set("a", "mortal", b"x", ttl=5000)
    net.set("a", "immortal", b"y")
    # a flood decrements the TTL by one at each hop: b holds 4999, c 4998
    return lambda: all(net.keys(n) == {"mortal", "immortal"} for n in net.stores)


def _ttl_expiry(net):
    net.add("a")
    net.add("b")
    net.link("a", "b")
    assert wait_until(net.initialized)
    net.set("a", "mortal", b"x", ttl=150)
    net.set("a", "immortal", b"y")
    return lambda: all(net.keys(n) == {"immortal"} for n in net.stores)


FLOOD_SCENARIOS = {
    "star": _star,
    "ring": _ring,
    "three_way_sync": _three_way_sync,
    "ttl_decrement_on_flood": _ttl_decrement_on_flood,
    "ttl_expiry": _ttl_expiry,
}


@pytest.mark.parametrize("scenario", sorted(FLOOD_SCENARIOS))
def test_flooding_matches_reference(scenario):
    """The same writes into the same topology of stores in each package:
    once both have converged, every store holds the same wire bytes."""
    final = {}
    for name, pkg in PACKAGES.items():
        net = Net(pkg)
        try:
            converged = FLOOD_SCENARIOS[scenario](net)
            assert wait_until(converged), (name, scenario)
            final[name] = net.stored()
        finally:
            net.stop()
    assert final["port"] == final["jax"]
    if scenario == "ttl_decrement_on_flood":
        ttls = {n: wire.loads(b, Dict[str, Value])["mortal"] for n, b in final["port"].items()}
        assert [ttls[n].ttl for n in "abc"] == [5000, 4999, 4998]


def test_fault_seams_recover_as_reference():
    """The ``kvstore.full_sync`` seam armed ``fail_n(2)`` while two stores
    peer, then ``kvstore.flood`` failing half the floods (seeded): in both
    packages the failures are counted, the peers' backoff re-syncs
    converge them, and both stores end holding the same bytes."""
    final = {}
    for name, pkg in PACKAGES.items():
        inj = pkg.injector()
        net = Net(pkg)
        try:
            a, b = net.add("node-a"), net.add("node-b")
            inj.arm("kvstore.full_sync", pkg.FaultSchedule.fail_n(2))
            net.link("node-a", "node-b")
            for i in range(5):
                a.set_key(f"soak:{i}", b"p%d" % i)
            assert wait_until(net.initialized), name
            inj.disarm("kvstore.full_sync")
            failures = sum(s.store.counters()["kvstore.full_sync_failures"]
                           for s in net.stores.values())
            assert failures == 2, (name, failures)
            inj.arm("kvstore.flood", pkg.FaultSchedule.fail_with_probability(0.5, seed=11))
            for i in range(5, 15):
                a.set_key(f"soak:{i}", b"p%d" % i)
            inj.disarm("kvstore.flood")
            want = {f"soak:{i}" for i in range(15)}
            assert wait_until(lambda: net.keys("node-b") == want and net.initialized()), name
            final[name] = net.stored()
        finally:
            inj.reset()
            net.stop()
    assert final["port"] == final["jax"]


def test_dump_difference_matches_reference():
    """The responder side of the three-way sync: the same store asked
    with the same hashes answers the same keys, and the same keys to be
    pushed back."""
    rng = np.random.default_rng(77)
    mine, theirs = {}, {}
    for key in KEYS:
        v = rand_value(rng)
        w = rand_value(rng)
        if v.value is not None and v.ttl == TTL_INFINITY:
            mine[key] = v
        if w.hash is not None and rng.random() < 0.7:
            theirs[key] = w
    theirs["only-theirs"] = Value(1, "node-c", b"t", TTL_INFINITY, 0,
                                  wire.generate_hash(1, "node-c", b"t"))
    out = {}
    for name, pkg in PACKAGES.items():
        net = Net(pkg)
        try:
            s = net.add("node-a")
            cross = {k: pkg.wire.loads(wire.dumps(v), pkg.Value) for k, v in mine.items()}
            s.store.set_key_vals("0", pkg.KeySetParams(key_vals=cross))
            hashes = {k: pkg.wire.loads(wire.dumps(v), pkg.Value) for k, v in theirs.items()}
            pub = s.store.dump_with_filters("0", pkg.KeyDumpParams(key_val_hashes=hashes))
            out[name] = (pkg.wire.dumps(pub.key_vals), sorted(pub.tobe_updated_keys))
        finally:
            net.stop()
    assert out["port"] == out["jax"]
    assert out["port"][1]  # the requester has keys to push back


# -- the client ----------------------------------------------------------------


def test_client_persist_wins_back_ownership_as_reference():
    """``KvStoreClient.persist_key`` against an override with a higher
    version: both packages win the key back at the same version."""
    final = {}
    for name, pkg in PACKAGES.items():
        net = Net(pkg)
        evb = pkg.evb.OpenrEventBase(f"client-evb:{name}")
        evb.run_in_thread()
        try:
            s = net.add("node-a")
            client = pkg.client.KvStoreClient(evb, "node-a", s.store,
                                              ttl_refresh_interval_s=0.1)
            client.persist_key("0", "contested", b"mine")
            s.set_key("contested", b"theirs", version=5, originator="node-z")
            assert wait_until(lambda: (v := s.get_key("contested")) is not None
                              and v.originator_id == "node-a" and v.version > 5), name
            v = s.get_key("contested")
            final[name] = (v.version, v.originator_id, v.value, v.ttl)
        finally:
            client.stop()
            evb.stop()
            evb.join()
            net.stop()
    assert final["port"] == final["jax"] == (6, "node-a", b"mine", TTL_INFINITY)


def test_client_subscription_and_ttl_refresh_as_reference():
    """A subscribed key's callback and a persisted key's TTL refresh: the
    callback sees the same values, and the refreshed key stays alive
    past its TTL in both packages."""
    seen = {}
    for name, pkg in PACKAGES.items():
        net = Net(pkg)
        evb = pkg.evb.OpenrEventBase(f"client-evb:{name}")
        evb.run_in_thread()
        try:
            s = net.add("node-a")
            client = pkg.client.KvStoreClient(evb, "node-a", s.store,
                                              ttl_refresh_interval_s=0.05)
            hits = []
            client.subscribe_key("0", "watched", lambda k, v: hits.append((k, v)))
            s.set_key("watched", b"1")
            s.set_key("watched", b"2", version=2)
            client.persist_key("0", "heartbeat", b"alive", ttl=300)
            assert wait_until(lambda: len(hits) >= 2), name
            assert wait_until(lambda: (v := s.get_key("heartbeat")) is not None
                              and v.ttl_version >= 3), name
            v = s.get_key("heartbeat")
            seen[name] = ([(k, pkg.wire.dumps(x)) for k, x in hits[:2]],
                          (v.version, v.originator_id, v.value))
        finally:
            client.stop()
            evb.stop()
            evb.join()
            net.stop()
    assert seen["port"] == seen["jax"]


# -- DUAL ----------------------------------------------------------------------


class DualBus:
    """Synchronous message bus running one package's ``DualNode``s over
    an edge list (the reference suite's ``DualNetwork``); ``log`` keeps
    every delivered message as wire bytes."""

    def __init__(self, pkg, edges, roots):
        self.pkg = pkg
        self.nodes = {n: pkg.dual.DualNode(n, is_root=n in roots)
                      for n in sorted({n for e in edges for n in e[:2]})}
        self.edges = {}
        self.queue = deque()
        self.log = []
        for a, b, cost in edges:
            self.edges[(a, b)] = self.edges[(b, a)] = cost
        for a, b, cost in edges:
            self._enqueue(a, self.nodes[a].peer_up(b, cost))
            self._enqueue(b, self.nodes[b].peer_up(a, cost))
        self.drain()

    def _enqueue(self, sender, msgs):
        for neighbor, batch in sorted(msgs.items()):
            for msg in batch:
                self.queue.append((sender, neighbor, msg))

    def drain(self):
        for _ in range(100_000):
            if not self.queue:
                return
            sender, receiver, msg = self.queue.popleft()
            if (sender, receiver) not in self.edges:
                continue
            self.log.append((sender, receiver, self.pkg.wire.dumps(msg)))
            self._enqueue(receiver, self.nodes[receiver].process_message(sender, msg))
        raise AssertionError("dual message storm")

    def cut(self, a, b):
        self.edges.pop((a, b), None)
        self.edges.pop((b, a), None)
        self._enqueue(a, self.nodes[a].peer_down(b))
        self._enqueue(b, self.nodes[b].peer_down(a))
        self.drain()

    def change_cost(self, a, b, cost):
        self.edges[(a, b)] = self.edges[(b, a)] = cost
        self._enqueue(a, self.nodes[a].peer_cost_change(b, cost))
        self._enqueue(b, self.nodes[b].peer_cost_change(a, cost))
        self.drain()

    def state(self, roots):
        out = {}
        for name, node in self.nodes.items():
            per_root = {}
            for root in sorted(roots):
                d = node.get_dual(root)
                per_root[root] = (d.state.name, int(d.distance) if d.distance < 2**62 else -1,
                                  d.nexthop, sorted(d.children()),
                                  sorted(node.spt_peers(root)))
            out[name] = (per_root, node.pick_flood_root())
        return out


RING6 = [(f"n{i}", f"n{(i + 1) % 6}", 1) for i in range(6)]
MESH = [("r", "a", 4), ("r", "b", 1), ("a", "b", 1), ("a", "c", 2), ("b", "c", 6), ("c", "d", 1)]
DUAL_SCENARIOS = {
    "line": ([("r", "a", 1), ("a", "b", 1), ("b", "c", 1)], {"r"}, []),
    "weighted_mesh": (MESH, {"r"}, [("cost", "r", "b", 9), ("cut", "a", "c")]),
    "ring": (RING6, {"n0"}, [("cut", "n0", "n1"), ("cost", "n3", "n4", 5)]),
    "multi_root": ([("r1", "a", 1), ("a", "r2", 1), ("r2", "b", 1)], {"r1", "r2"},
                   [("cut", "a", "r2")]),
}


@pytest.mark.parametrize("scenario", sorted(DUAL_SCENARIOS))
def test_dual_matches_reference(scenario):
    """The same topology, roots and churn (link cuts, cost changes) on
    each package's DUAL: the same messages in the same order, and every
    node's per-root state, parent, children, SPT peers and flood root."""
    edges, roots, churn = DUAL_SCENARIOS[scenario]
    out = {}
    for name, pkg in PACKAGES.items():
        bus = DualBus(pkg, edges, roots)
        states = [bus.state(roots)]
        for step in churn:
            if step[0] == "cut":
                bus.cut(step[1], step[2])
            else:
                bus.change_cost(*step[1:])
            states.append(bus.state(roots))
        out[name] = (bus.log, states)
    assert out["port"][1] == out["jax"][1]
    assert out["port"][0] == out["jax"][0]


def _spt_converged(net, root, n):
    """Every store of a ring of ``n`` rooted at ``root`` elected it, is
    passive at its ring distance, and every parent lists its child."""
    infos = {name: s.store.spt_infos("0") for name, s in net.stores.items()}
    for name, info in infos.items():
        i = int(name[1:])
        mine = info["infos"].get(root)
        if (info["flood_root_id"] != root or mine is None or not mine["passive"]
                or mine["cost"] != min(i, n - i)):
            return False
    for name, info in infos.items():
        parent = info["infos"][root]["parent"]
        if parent not in (None, name) and name not in infos[parent]["infos"][root]["children"]:
            return False
    return True


def test_flood_optimisation_spt_infos_match_reference():
    """A ring of five stores with DUAL flood optimisation, rooted at r0:
    once the spanning tree has formed, every store's ``spt_infos`` (per
    root: passive, cost, parent, children; the elected root; the flood
    peers) is the same in both packages, and a key still floods to
    every store over the tree."""
    out = {}
    for name, pkg in PACKAGES.items():
        net = Net(pkg, enable_flood_optimization=True)
        try:
            for i in range(5):
                net.add(f"r{i}", is_flood_root=(i == 0))
            for i in range(5):
                net.link(f"r{i}", f"r{(i + 1) % 5}")
            assert wait_until(net.initialized), name
            assert wait_until(lambda: _spt_converged(net, "r0", 5)), name
            infos = {}
            for n, s in sorted(net.stores.items()):
                info = s.store.spt_infos("0")
                infos[n] = (
                    {r: (v["passive"], v["cost"], v["parent"], sorted(v["children"]))
                     for r, v in sorted(info["infos"].items())},
                    info["flood_root_id"], sorted(info["flood_peers"]),
                )
            net.set("r2", "adj:r2", b"v", originator="r2")
            assert wait_until(lambda: all("adj:r2" in net.keys(n) for n in net.stores)), name
            out[name] = infos
        finally:
            net.stop()
    assert out["port"] == out["jax"]
