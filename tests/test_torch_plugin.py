"""The port's plugin hook (``plugin.py``) and its SPF backend registry
(``decision/spf_solver.py::register_spf_backend``) against
``openr_tpu``'s.

A registered plugin starts once per port ``OpenrNode`` with the node's
queues, and a static MPLS route it injects reaches Decision's route
database as it does in the reference. A backend registered under a new
name builds the same route database as the host backend and as the
reference's registered backend; the built-in names cannot be taken, and
nothing on the card path steps down to a registered backend.
"""

from __future__ import annotations

import time

import pytest

from openr_tpu import plugin as jax_plugin
from openr_tpu.daemon import OpenrNode as JaxNode
from openr_tpu.decision import spf_solver as jax_spf
from openr_tpu.decision.prefix_state import PrefixState as JaxPrefixState
from openr_tpu.graph.linkstate import LinkState as JaxLinkState
from openr_tpu.models import topologies as jax_topologies
from openr_tpu.spark.io_provider import MockIoProvider as JaxIo
from openr_tpu import types as jax_types
from openr_tpu.types import fib as jax_fib
from openr_tpu_torch import carry, plugin
from openr_tpu_torch.config.config import OpenrConfig
from openr_tpu_torch.daemon import OpenrNode
from openr_tpu_torch.decision import spf_solver
from openr_tpu_torch.decision.decision import Decision
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.graph.linkstate import LinkState
from openr_tpu_torch.messaging.queue import ReplicateQueue
from openr_tpu_torch.models import topologies
from openr_tpu_torch.spark.io_provider import MockIoProvider
from openr_tpu_torch import types
from openr_tpu_torch.types import fib

SPARK = dict(hello_interval_s=0.05, fast_hello_interval_s=0.02, handshake_interval_s=0.02,
             heartbeat_interval_s=0.05, hold_time_s=2.0)
WAIT_S = 15.0


@pytest.fixture(autouse=True)
def clean_registration():
    yield
    plugin.unregister_plugin()
    jax_plugin.unregister_plugin()


def test_default_hook_is_a_noop():
    assert not plugin.has_plugin()
    plugin.plugin_start(None)
    plugin.plugin_stop()


def _static_route_run(node_cls, io_cls, plug, T, fib_mod, **kwargs):
    """Two daemons with a registered plugin that injects a static MPLS
    route into each; returns the plugin's calls and a's MPLS routes."""
    received, stopped = [], []

    def start(args):
        received.append(args)
        args.static_routes_queue.push(fib_mod.RouteDatabaseDelta(
            this_node_name="a", mpls_routes_to_update=[T.MplsRoute(
                top_label=60001,
                next_hops=[T.NextHop(address=T.BinaryAddress.from_str("fd00::99"))])]))

    plug.register_plugin(start, lambda: stopped.append(True))
    io = io_cls()
    io.connect_pair("if_ab", "if_ba", 5)
    registry = {}
    nodes = [node_cls(n, io, node_registry=registry, spark_config=SPARK, **kwargs)
             for n in ("a", "b")]
    try:
        for n in nodes:
            n.start()
        nodes[0].add_interface("if_ab")
        nodes[1].add_interface("if_ba")
        deadline = time.monotonic() + WAIT_S
        routes = None
        while time.monotonic() < deadline:
            routes = nodes[0].decision.get_decision_route_db()
            if 60001 in routes.mpls_routes:
                break
            time.sleep(0.05)
        queues_ok = any(args.static_routes_queue is nodes[0].static_routes for args in received)
        mpls = {label: sorted(nh.address.to_str() for nh in r.nexthops)
                for label, r in routes.mpls_routes.items()}
    finally:
        for n in nodes:
            n.stop()
        io.stop()
    return len(received), queues_ok, mpls, stopped


def test_plugin_receives_args_and_injects_static_routes():
    port = _static_route_run(OpenrNode, MockIoProvider, plugin, types, fib, device="cpu")
    ref = _static_route_run(JaxNode, JaxIo, jax_plugin, jax_types, jax_fib)
    assert port == ref
    assert port[0] == 2 and port[1] and 60001 in port[2] and port[3] == [True, True]


def test_plugin_receives_the_bgp_config():
    got = {}
    cfg = OpenrConfig.from_dict({"node_name": "n1",
                                 "bgp_config": {"router_id": "10.0.0.1", "local_as": 65001}})
    plugin.register_plugin(lambda args: got.__setitem__("bgp", args.bgp_config))
    plugin.plugin_start(plugin.PluginArgs(
        prefix_updates_queue=ReplicateQueue(name="p"),
        static_routes_queue=ReplicateQueue(name="s"),
        route_updates_reader=ReplicateQueue(name="r").get_reader(),
        config=cfg, bgp_config=cfg.bgp_config))
    assert got["bgp"] is cfg.bgp_config


def _mesh(T_topologies, LS, PS):
    topo = T_topologies.random_mesh(12, degree=3, seed=1, max_metric=9)
    ls = LS(area=topo.area)
    for name in sorted(topo.adj_dbs):
        ls.update_adjacency_database(topo.adj_dbs[name])
    ps = PS()
    for pdb in topo.prefix_dbs.values():
        ps.update_prefix_database(pdb)
    return {topo.area: ls}, ps


@pytest.mark.parametrize("root", ("node-0", "node-5"))
def test_a_registered_backend_builds_the_host_and_reference_route_database(root):
    spf_solver.register_spf_backend(
        "my-solver", lambda ls, r: spf_solver.SpfView(ls, r, "host"))
    jax_spf.register_spf_backend("my-solver", lambda ls, r: jax_spf.SpfView(ls, r, "host"))
    try:
        areas, ps = _mesh(topologies, LinkState, PrefixState)
        custom = spf_solver.SpfSolver(root, backend="my-solver", device="cpu").build_route_db(
            root, areas, ps)
        stock = spf_solver.SpfSolver(root, backend="host", device="cpu").build_route_db(
            root, areas, ps)
        jax_areas, jax_ps = _mesh(jax_topologies, JaxLinkState, JaxPrefixState)
        ref = jax_spf.SpfSolver(root, backend="my-solver").build_route_db(root, jax_areas, jax_ps)
        plain = carry.route_db_to_plain(custom.to_route_db(root))
        assert plain == carry.route_db_to_plain(stock.to_route_db(root))
        assert plain == carry.route_db_to_plain(ref.to_route_db(root))
        assert plain[1]
    finally:
        spf_solver.unregister_spf_backend("my-solver")
        jax_spf.unregister_spf_backend("my-solver")


def test_builtin_backend_names_are_protected_and_unknown_ones_refused():
    for name in ("device", "native", "host"):
        with pytest.raises(AssertionError):
            spf_solver.register_spf_backend(name, lambda ls, root: None)
    with pytest.raises(ValueError, match="unknown SPF backend"):
        spf_solver.SpfSolver("x", backend="nowhere", device="cpu")
    spf_solver.register_spf_backend("mine", lambda ls, root: spf_solver.SpfView(ls, root, "host"))
    solver = spf_solver.SpfSolver("x", device="cpu")
    solver.set_backend("mine")
    assert solver.backend == "mine"
    spf_solver.unregister_spf_backend("mine")
    spf_solver.unregister_spf_backend("mine")  # twice is harmless
    with pytest.raises(ValueError, match="unknown SPF backend"):
        solver.set_backend("mine")


def test_the_card_path_never_steps_down_to_a_registered_backend():
    """Decision's ladder under the device backend goes to the native
    core; under a registered backend it stays on that backend."""
    spf_solver.register_spf_backend("mine", lambda ls, root: spf_solver.SpfView(ls, root, "host"))
    made = []
    try:
        made.append(Decision("a", ReplicateQueue(), ReplicateQueue(), device="cpu"))
        assert made[-1]._fallback_backend == "native"
        made.append(Decision("a", ReplicateQueue(), ReplicateQueue(), solver_backend="mine",
                             device="cpu"))
        assert made[-1]._fallback_backend == "mine"
    finally:
        for d in made:
            d.stop()  # ends its queue readers' threads
        spf_solver.unregister_spf_backend("mine")
