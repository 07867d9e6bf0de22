"""The port's LinkMonitor (``linkmonitor/link_monitor.py``), with its
``RangeAllocator`` node-label election and ``PersistentStore`` drain
state, against ``openr_tpu``'s, on the same neighbour events.

Each scenario of ``tests/test_linkmonitor.py`` runs once in each package
over a KvStore of its own. The bar: the same ``adj:`` keys in every area,
each holding the same adjacency database byte for byte once the
wall-clock readings are blanked (the adjacencies' ``timestamp``, the perf
events' ``unix_ts``); the same neighbour counters; the same elected node
label. A drain state persisted by one package is read back by the other.
Every wait polls against a deadline; every module and event base is
stopped.
"""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace

import pytest

from openr_tpu.config_store import persistent_store as jax_store_mod
from openr_tpu.kvstore import client as jax_client
from openr_tpu.kvstore import store as jax_kvstore
from openr_tpu.linkmonitor import link_monitor as jax_lm
from openr_tpu.messaging import queue as jax_queue
from openr_tpu import types as jax_types
from openr_tpu.types import spark as jax_spark_types
from openr_tpu.utils import eventbase as jax_evb
from openr_tpu.utils import keys as jax_keys
from openr_tpu.utils import wire as jax_wire
from openr_tpu_torch.config_store import persistent_store as port_store_mod
from openr_tpu_torch.kvstore import client as port_client
from openr_tpu_torch.kvstore import store as port_kvstore
from openr_tpu_torch.linkmonitor import link_monitor as port_lm
from openr_tpu_torch.messaging import queue as port_queue
from openr_tpu_torch import types as port_types
from openr_tpu_torch.types import spark as port_spark_types
from openr_tpu_torch.utils import eventbase as port_evb
from openr_tpu_torch.utils import keys as port_keys
from openr_tpu_torch.utils import wire as port_wire

PKGS = {
    "port": SimpleNamespace(store=port_store_mod, client=port_client, kvstore=port_kvstore,
                            lm=port_lm, queue=port_queue, T=port_types, S=port_spark_types,
                            evb=port_evb, keys=port_keys, wire=port_wire),
    "jax": SimpleNamespace(store=jax_store_mod, client=jax_client, kvstore=jax_kvstore,
                           lm=jax_lm, queue=jax_queue, T=jax_types, S=jax_spark_types,
                           evb=jax_evb, keys=jax_keys, wire=jax_wire),
}
WAIT_S = 10.0


def wait_until(pred, timeout=WAIT_S, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


class Harness:
    """``tests/test_linkmonitor.py``'s harness over one package."""

    def __init__(self, p, config_store=None, areas=None, **lm_kwargs):
        self.p = p
        self.areas = areas or ["0"]
        self.kvstore = p.kvstore.KvStore(node_id="lm-test", areas=self.areas)
        self.kvstore.start()
        self.client_evb = p.evb.OpenrEventBase(name="lm-test-client")
        self.client_evb.run_in_thread()
        self.client = p.client.KvStoreClient(self.client_evb, "node-a", self.kvstore)
        self.neighbor_q = p.queue.ReplicateQueue(name="lm:neighborUpdates")
        self.interface_q = p.queue.ReplicateQueue(name="lm:interfaceUpdates")
        self.lm = p.lm.LinkMonitor(
            "node-a", neighbor_updates_queue=self.neighbor_q,
            interface_updates_queue=self.interface_q, kvstore_client=self.client,
            kvstore=self.kvstore, config_store=config_store, areas=areas, **lm_kwargs)
        self.lm.start()

    def neighbor(self, node, local_if, remote_if, area="0", rtt_us=0):
        return self.p.S.SparkNeighbor(
            node_name=node, local_if_name=local_if, remote_if_name=remote_if,
            transport_address_v6=self.p.T.BinaryAddress.from_str("fe80::2"), area=area,
            rtt_us=rtt_us)

    def emit(self, kind, *args, **kwargs):
        self.neighbor_q.push(self.p.S.SparkNeighborEvent(
            getattr(self.p.S.SparkNeighborEventType, kind), self.neighbor(*args, **kwargs)))

    def adj_db(self, area="0"):
        key = self.p.keys.adj_key("node-a")
        val = self.kvstore.get_key_vals(area, [key]).get(key)
        if val is None or val.value is None:
            return None
        return self.p.wire.loads(val.value, self.p.T.AdjacencyDatabase)

    def wait_adj(self, pred, area="0"):
        assert wait_until(lambda: (db := self.adj_db(area)) is not None and pred(db)), \
            self.adj_db(area)

    def state(self):
        """Every area's ``adj:`` values, clock readings blanked, as wire bytes;
        the neighbour counters; each area's node label."""
        out = {}
        for area in self.areas:
            dump = self.kvstore.dump_with_filters(area).key_vals
            for key in sorted(k for k in dump if k.startswith("adj:")):
                db = self.p.wire.loads(dump[key].value, self.p.T.AdjacencyDatabase)
                db = dataclasses.replace(db, adjacencies=tuple(
                    dataclasses.replace(a, timestamp=0) for a in db.adjacencies))
                if db.perf_events is not None:
                    db = dataclasses.replace(db, perf_events=dataclasses.replace(
                        db.perf_events, events=[dataclasses.replace(e, unix_ts=0)
                                                for e in db.perf_events.events]))
                out[(area, key)] = self.p.wire.dumps(db)
        counters = {k: v for k, v in self.lm.get_counters().items()
                    if k in ("link_monitor.neighbor_up", "link_monitor.neighbor_down")}
        labels = {a: self.lm.node_label_for(a) for a in self.areas}
        return out, counters, labels

    def stop(self):
        self.lm.stop()
        self.client_evb.stop()
        self.client_evb.join()
        self.kvstore.stop()


def _up(h):
    h.emit("NEIGHBOR_UP", "b", "if_ab", "if_ba")
    h.wait_adj(lambda d: len(d.adjacencies) == 1)


def _down(h):
    _up(h)
    h.emit("NEIGHBOR_DOWN", "b", "if_ab", "if_ba")
    h.wait_adj(lambda d: len(d.adjacencies) == 0)


def _parallel(h):
    h.emit("NEIGHBOR_UP", "b", "if1_ab", "if1_ba")
    h.emit("NEIGHBOR_UP", "b", "if2_ab", "if2_ba")
    h.wait_adj(lambda d: len(d.adjacencies) == 2)


def _restart(h):
    _up(h)
    h.emit("NEIGHBOR_RESTARTING", "b", "if_ab", "if_ba")
    time.sleep(0.3)
    h.emit("NEIGHBOR_RESTARTED", "b", "if_ab", "if_ba")
    time.sleep(0.3)
    h.wait_adj(lambda d: len(d.adjacencies) == 1)


def _node_overload(h):
    _up(h)
    h.lm.set_node_overload(True)
    h.wait_adj(lambda d: d.is_overloaded)


def _node_overload_cleared(h):
    _node_overload(h)
    h.lm.set_node_overload(False)
    h.wait_adj(lambda d: not d.is_overloaded)


def _link_overload(h):
    _up(h)
    h.lm.set_link_overload("if_ab", True)
    h.wait_adj(lambda d: d.adjacencies[0].is_overloaded)


def _metric_override(h):
    _up(h)
    h.lm.set_link_metric("if_ab", "b", 777)
    h.wait_adj(lambda d: d.adjacencies[0].metric == 777)


def _metric_override_cleared(h):
    _metric_override(h)
    h.lm.set_link_metric("if_ab", "b", None)
    h.wait_adj(lambda d: d.adjacencies[0].metric != 777)


def _rtt_metric(h):
    h.emit("NEIGHBOR_UP", "b", "if_ab", "if_ba", rtt_us=20000)
    h.wait_adj(lambda d: len(d.adjacencies) == 1)


def _multi_area(h):
    h.emit("NEIGHBOR_UP", "b", "if_ab", "if_ba", area="0")
    h.emit("NEIGHBOR_UP", "c", "if_ac", "if_ca", area="1")
    h.wait_adj(lambda d: len(d.adjacencies) == 1, area="0")
    h.wait_adj(lambda d: len(d.adjacencies) == 1, area="1")


def _elected_label(h):
    assert wait_until(lambda: h.lm.node_label_for("0") != 0)
    _up(h)
    h.wait_adj(lambda d: d.node_label != 0)


SCENARIOS = {
    "neighbor_up": (_up, {}),
    "neighbor_down": (_down, {}),
    "parallel_adjacencies": (_parallel, {}),
    "neighbor_restart": (_restart, {}),
    "node_overload": (_node_overload, {}),
    "node_overload_cleared": (_node_overload_cleared, {}),
    "link_overload": (_link_overload, {}),
    "metric_override": (_metric_override, {}),
    "metric_override_cleared": (_metric_override_cleared, {}),
    "rtt_metric": (_rtt_metric, {"use_rtt_metric": True}),
    "multi_area": (_multi_area, {"areas": ["0", "1"]}),
    "static_label": (_up, {"enable_segment_routing": True, "node_label": 777}),
    "elected_label": (_elected_label, {"enable_segment_routing": True}),
}


def _run(pkg, scenario):
    script, kwargs = SCENARIOS[scenario]
    h = Harness(PKGS[pkg], **kwargs)
    try:
        script(h)
        return h.state()
    finally:
        h.stop()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_neighbor_events_give_the_reference_adjacency_databases(scenario):
    port, ref = _run("port", scenario), _run("jax", scenario)
    assert port[0] and sorted(port[0]) == sorted(ref[0])
    for key in port[0]:
        assert port[0][key] == ref[0][key], key
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    if scenario == "static_label":
        assert port[2] == {"0": 777}


@pytest.mark.parametrize("writer,reader", (("port", "jax"), ("jax", "port")))
def test_drain_state_persisted_by_one_package_is_read_by_the_other(tmp_path, writer, reader):
    path = str(tmp_path / "lm.bin")
    w = PKGS[writer]
    store = w.store.PersistentStore(path, save_throttle_s=0.0)
    h = Harness(w, config_store=store)
    try:
        _node_overload(h)
    finally:
        h.stop()
        store.stop()
    r = PKGS[reader]
    store2 = r.store.PersistentStore(path, save_throttle_s=0.0)
    h2 = Harness(r, config_store=store2)
    try:
        assert h2.lm.is_overloaded
        _up(h2)
        h2.wait_adj(lambda d: d.is_overloaded)
    finally:
        h2.stop()
        store2.stop()
    assert open(path, "rb").read()


def test_persisted_label_is_reclaimed_as_in_the_reference():
    class DictStore:
        def __init__(self):
            self.data = {}

        def store(self, key, obj):
            self.data[key] = obj

        def load(self, key, cls=None):
            return self.data.get(key)

    labels = {}
    for pkg in ("port", "jax"):
        store = DictStore()
        h = Harness(PKGS[pkg], enable_segment_routing=True, config_store=store)
        try:
            assert wait_until(lambda: h.lm.node_label_for("0") != 0)
            first = h.lm.node_label_for("0")
        finally:
            h.stop()
        h2 = Harness(PKGS[pkg], enable_segment_routing=True, config_store=store)
        try:
            assert wait_until(lambda: h2.lm.node_label_for("0") == first)
        finally:
            h2.stop()
        labels[pkg] = first
    assert labels["port"] == labels["jax"]
    lo, hi = port_lm.SR_GLOBAL_RANGE
    assert lo <= labels["port"] <= hi


def test_two_nodes_elect_distinct_labels_over_one_store():
    a = Harness(PKGS["port"], enable_segment_routing=True)
    b_evb = port_evb.OpenrEventBase(name="lm-test-client-b")
    b_evb.run_in_thread()
    b = port_lm.LinkMonitor(
        "node-b", neighbor_updates_queue=port_queue.ReplicateQueue(),
        interface_updates_queue=port_queue.ReplicateQueue(),
        kvstore_client=port_client.KvStoreClient(b_evb, "node-b", a.kvstore),
        kvstore=a.kvstore, enable_segment_routing=True)
    b.start()
    try:
        assert wait_until(lambda: a.lm.node_label_for("0") and b.node_label_for("0"))
        assert a.lm.node_label_for("0") != b.node_label_for("0")
        assert a.lm._build_adj_db("0").node_label == a.lm.node_label_for("0")
    finally:
        b.stop()
        b_evb.stop()
        b_evb.join()
        a.stop()
