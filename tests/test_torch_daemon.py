"""The port's daemon (``daemon.py::OpenrNode``: Spark, LinkMonitor,
KvStore, PrefixManager, Decision, Fib, Monitor, the ctrl handler) against
``openr_tpu``'s, in the shape of ``tests/test_system.py::TestSystem`` and
``tests/test_multiarea.py::TestMultiAreaSystem``.

Each fabric of whole daemons runs once in each package over its own
``MockIoProvider``; the port's Decisions solve on ``device="cpu"`` (the
kernels' plain versions), the reference's as its own system tests run
them. Once converged, every daemon's Fib route database must equal the
reference daemon's of the same name, and every KvStore must hold the same
keys (and the same prefix advertisements, byte for byte). Every wait polls
against a deadline; every daemon and provider is stopped.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from openr_tpu.config import config as jax_config
from openr_tpu.daemon import OpenrNode as JaxNode
from openr_tpu.spark.io_provider import MockIoProvider as JaxIo
from openr_tpu.types import IpPrefix as JaxIpPrefix
from openr_tpu.types import PrefixType as JaxPrefixType
from openr_tpu_torch import carry
from openr_tpu_torch.config import config as port_config
from openr_tpu_torch.daemon import OpenrNode
from openr_tpu_torch.spark.io_provider import MockIoProvider
from openr_tpu_torch.types import IpPrefix, PrefixType

PKGS = {
    "port": SimpleNamespace(Node=OpenrNode, Io=MockIoProvider, IpPrefix=IpPrefix,
                            PrefixType=PrefixType, config=port_config,
                            kwargs={"device": "cpu"}),
    "jax": SimpleNamespace(Node=JaxNode, Io=JaxIo, IpPrefix=JaxIpPrefix,
                           PrefixType=JaxPrefixType, config=jax_config, kwargs={}),
}
SPARK_FAST = dict(hello_interval_s=0.05, fast_hello_interval_s=0.03, handshake_interval_s=0.03,
                  heartbeat_interval_s=0.05, hold_time_s=1.0, graceful_restart_time_s=2.0)
WAIT_S = 20.0


def wait_until(pred, timeout=WAIT_S, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


class Network:
    """``tests/test_system.py``'s network over one package."""

    def __init__(self, p):
        self.p = p
        self.io = p.Io()
        self.registry = {}
        self.nodes = {}
        self.links = []
        self.loopbacks = {}

    def add_node(self, name, idx, **kwargs):
        node = self.p.Node(name, self.io, node_registry=self.registry, v6_addr=f"fe80::{idx + 1}",
                           spark_config=SPARK_FAST, **self.p.kwargs, **kwargs)
        self.nodes[name] = node
        return node

    def link(self, a, b):
        self.links.append((a, b))
        self.io.connect_pair(f"if_{a}_{b}", f"if_{b}_{a}", 1)
        self.nodes[a].add_interface(f"if_{a}_{b}")
        self.nodes[b].add_interface(f"if_{b}_{a}")

    def start(self):
        for node in self.nodes.values():
            node.start()

    def stop(self):
        for node in self.nodes.values():
            node.stop()
        self.io.stop()

    def advertise(self, name, prefix):
        self.loopbacks[name] = self.nodes[name].advertise_loopback(prefix)
        return self.loopbacks[name]

    def settle(self):
        """Until every Decision holds every daemon's adjacencies to all its
        linked neighbours, every KvStore the same keys, and every Fib a
        route to every loopback but its own."""
        nbrs = {n: set() for n in self.nodes}
        for a, b in self.links:
            nbrs[a].add(b)
            nbrs[b].add(a)

        def done():
            for n, node in self.nodes.items():
                dbs = node.decision.get_adj_dbs().get("0", {})
                if any({adj.other_node_name for adj in dbs[x].adjacencies} != nbrs[x]
                       if x in dbs else True for x in self.nodes):
                    return False
            keys = [self.kvstore(n)[0] for n in self.nodes]
            return all(k == keys[0] for k in keys) and all(
                self.nexthops(n, p) for n in self.nodes
                for owner, p in self.loopbacks.items() if owner != n)

        assert wait_until(done)

    def routes(self, name):
        return carry.route_db_to_plain(self.nodes[name].get_fib_routes())

    def nexthops(self, name, prefix):
        for r in self.nodes[name].get_fib_routes().unicast_routes:
            if r.dest == prefix:
                return {nh.neighbor_node_name for nh in r.next_hops}
        return set()

    def kvstore(self, name, area="0"):
        """The keys of a daemon's KvStore, and its prefix values."""
        dump = self.nodes[name].kvstore.dump_with_filters(area).key_vals
        return sorted(dump), {k: v.value for k, v in dump.items() if k.startswith("prefix:")}


def _run(pkg, script):
    net = Network(PKGS[pkg])
    try:
        return script(net)
    finally:
        net.stop()


def _converged(net):
    return {n: net.routes(n) for n in net.nodes}, {n: net.kvstore(n) for n in net.nodes}


def _line(net):
    names = ["alpha", "beta", "gamma"]
    for i, name in enumerate(names):
        net.add_node(name, i)
    net.start()
    net.link("alpha", "beta")
    net.link("beta", "gamma")
    pfx = {n: net.advertise(n, f"fd00:{i}::1/128") for i, n in enumerate(names)}
    net.settle()
    assert net.nexthops("alpha", pfx["gamma"]) == {"beta"}
    return _converged(net)


def _square_reroute(net):
    for i, name in enumerate(["alpha", "beta", "gamma", "delta"]):
        net.add_node(name, i)
    net.start()
    for a, b in (("alpha", "beta"), ("beta", "delta"), ("alpha", "gamma"), ("gamma", "delta")):
        net.link(a, b)
    pfx = net.advertise("delta", "fd00:d::1/128")
    net.settle()
    assert net.nexthops("alpha", pfx) == {"beta", "gamma"}
    before = _converged(net)
    net.io.partition("if_beta_alpha")
    assert wait_until(lambda: net.nexthops("alpha", pfx) == {"gamma"})
    assert wait_until(lambda: "beta" not in {
        a.other_node_name
        for a in net.nodes["alpha"].decision.get_adj_dbs()["0"]["alpha"].adjacencies})
    return before, {"alpha": net.routes("alpha")}


def _monitor_logs(net):
    for i, name in enumerate(["alpha", "beta"]):
        net.add_node(name, i)
    net.start()
    net.link("alpha", "beta")
    pfx = net.nodes["beta"].advertise_loopback("fd00:b::1/128")
    assert wait_until(lambda: net.nexthops("alpha", pfx))

    def events(name):
        return {s.get("event") for s in net.nodes[name].monitor.get_event_logs(100)}

    for kind in ("NEIGHBOR_UP", "ADD_PEER", "KVSTORE_FULL_SYNC"):
        assert wait_until(lambda k=kind: k in events("alpha")), kind
    up = next(s for s in net.nodes["alpha"].monitor.get_event_logs(100)
              if s.get("event") == "NEIGHBOR_UP")
    fields = (up.get("neighbor"), up.get("node_name"))
    net.io.partition("if_beta_alpha")
    net.io.partition("if_alpha_beta")
    assert wait_until(lambda: "NEIGHBOR_DOWN" in events("alpha"))
    served = any('"NEIGHBOR_DOWN"' in raw
                 for raw in net.nodes["alpha"].ctrl_handler.get_event_logs(100))
    return fields, served, sorted(e for e in events("alpha") & {
        "NEIGHBOR_UP", "NEIGHBOR_DOWN", "ADD_PEER", "DEL_PEER", "KVSTORE_FULL_SYNC"})


def _restart(net):
    for i, name in enumerate(["alpha", "beta"]):
        net.add_node(name, i)
    net.start()
    net.link("alpha", "beta")
    net.advertise("beta", "fd00:b::1/128")
    net.settle()
    return _converged(net)


SYSTEM = {"line": _line, "square_reroute": _square_reroute, "monitor_logs": _monitor_logs,
          "restart": _restart}


@pytest.mark.parametrize("scenario", sorted(SYSTEM))
def test_system_scenario_converges_as_the_reference(scenario):
    port = _run("port", SYSTEM[scenario])
    ref = _run("jax", SYSTEM[scenario])
    assert port == ref
    if scenario == "monitor_logs":
        assert port[0] == ("beta", "alpha") and port[1]
    if scenario == "restart":
        keys = port[1]["alpha"][0]
        assert any(k.startswith("adj:alpha") for k in keys)
        assert any(k.startswith("prefix:beta") for k in keys)


def _multi_area(net):
    """a -(area 1)- border -(area 2)- c, each advertising a loopback."""
    net.add_node("a", 0, area="1")
    net.add_node("border", 1, area="1", areas=["1", "2"],
                 interface_areas={"if_border_c": "2"})
    net.add_node("c", 2, area="2")
    net.start()
    net.link("a", "border")
    net.link("border", "c")
    a_pfx = net.nodes["a"].advertise_loopback("fd00:a::1/128")
    c_pfx = net.nodes["c"].advertise_loopback("fd00:c::1/128")
    assert wait_until(lambda: net.nexthops("c", a_pfx) == {"border"})
    assert wait_until(lambda: net.nexthops("a", c_pfx) == {"border"})
    assert not net.nexthops("a", a_pfx)
    assert wait_until(lambda: net.kvstore("a", "1")[0] == net.kvstore("border", "1")[0]
                      and net.kvstore("c", "2")[0] == net.kvstore("border", "2")[0])
    redist = {p.to_str(): (e.area_stack, t) for p, (e, t) in
              net.nodes["border"].prefix_manager.get_redistributed().items()}
    routes = {n: net.routes(n) for n in net.nodes}
    keys = {(n, area): net.kvstore(n, area)[0] for n in net.nodes
            for area in net.nodes[n].areas}
    net.nodes["a"].prefix_manager.withdraw_prefixes([a_pfx])
    assert wait_until(lambda: not net.nexthops("c", a_pfx))
    return routes, redist, keys, net.routes("c")


def test_multi_area_redistribution_converges_as_the_reference():
    port = _run("port", _multi_area)
    assert port == _run("jax", _multi_area)
    assert port[1] == {"fd00:a::1/128": (("1",), ("2",)), "fd00:c::1/128": (("2",), ("1",))}


def test_daemon_wires_its_options_as_the_reference():
    io = MockIoProvider()
    try:
        node = OpenrNode("flags-node", io, enable_v4=True, enable_lfa=True,
                         enable_ordered_fib=True, enable_bgp_route_programming=False,
                         enable_rib_policy=False, device="cpu")
        solver = node.decision.spf_solver
        assert (solver.enable_v4, solver.compute_lfa_paths, solver.enable_ordered_fib,
                solver.bgp_dry_run, node.decision._enable_rib_policy) == \
            (True, True, True, True, False)
        assert solver.device == torch.device("cpu")
        with pytest.raises(ValueError):
            OpenrNode("x", io, areas=["1", "2"], interface_areas={"eth0": "3"}, area="1",
                      device="cpu")
        with pytest.raises(ValueError):
            OpenrNode("y", io, areas=["1", "2"], device="cpu")
    finally:
        io.stop()


def _allocating_node(pkg):
    p = PKGS[pkg]
    io = p.Io()
    node = p.Node("alloc-node", io, prefix_alloc=p.config.PrefixAllocationConfig(
        enabled=True, seed_prefix="fd00:da::/60", alloc_prefix_len=64), **p.kwargs)
    node.start()
    try:
        assert wait_until(lambda: node.prefix_allocator.allocated_prefix is not None)
        assert wait_until(lambda: any(e.type == p.PrefixType.PREFIX_ALLOCATOR
                                      for e in node.prefix_manager.get_prefixes()))
        return node.prefix_allocator.allocated_prefix.to_str(), sorted(
            e.prefix.to_str() for e in node.prefix_manager.get_prefixes())
    finally:
        node.stop()
        io.stop()


def test_daemon_prefix_allocation_elects_the_reference_prefix():
    assert _allocating_node("port") == _allocating_node("jax")


def test_ctrl_handler_serves_the_daemon():
    """The in-process ctrl handler answers from the port's modules as the
    reference's does from its own."""
    out = {}
    for pkg in ("port", "jax"):
        def script(net):
            for i, name in enumerate(["alpha", "beta"]):
                net.add_node(name, i)
            net.start()
            net.link("alpha", "beta")
            pfx = net.nodes["beta"].advertise_loopback("fd00:b::1/128")
            assert wait_until(lambda: net.nexthops("alpha", pfx))
            h = net.nodes["alpha"].ctrl_handler
            routes = h.get_unicast_routes()
            return (h.get_my_node_name(), sorted(r.dest.to_str() for r in routes),
                    sorted(h.get_kvstore_key_vals(["adj:alpha", "adj:beta"])),
                    h.dryrun_config('{"node_name": "n1"}'),
                    h.dryrun_config('{"node_name": ""}')["valid"])

        out[pkg] = _run(pkg, script)
    assert out["port"] == out["jax"]
    assert out["port"][1] == ["fd00:b::1/128"]
